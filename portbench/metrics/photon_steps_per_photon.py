"""Steps a photon takes on the step loop: the live photons summed over
every step (the program's counter ``step.live_photons``) over the
photons propagated, in every call of the window, traced or not.  Layer:
ops/photon.propagate."""
from portbench.program_spans import instrument  # noqa: F401


def read(ctx):
    steps = photons = 0
    for part in (ctx['traced'], ctx['rest']):
        rec = getattr(part['counters'], 'program', None) if part else None
        if rec is None or 'step.live_photons' not in rec.counts:
            continue
        steps += rec.counts['step.live_photons']
        photons += sum(n for n, _, _ in part['counters'].propagations)
    return steps / photons if photons else None

"""Share of the photons propagated that end with a bulk reemission in
their history: the program's counter ``simulate.reemitted`` (a batch's
photons whose end flags carry ``BULK_REEMIT``), summed over every call
of the window, traced or not, over the photons propagated.  Layer:
ops/propagate.physics_update."""
from portbench.program_spans import instrument  # noqa: F401


def read(ctx):
    reemitted = photons = 0
    for part in (ctx['traced'], ctx['rest']):
        rec = getattr(part['counters'], 'program', None) if part else None
        if rec is None or 'simulate.reemitted' not in rec.counts:
            continue
        reemitted += rec.counts['simulate.reemitted']
        photons += sum(n for n, _, _ in part['counters'].propagations)
    return reemitted / photons if photons else None

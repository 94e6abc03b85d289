"""Steps of the step loop a batch (``GPUPhotons.last_steps``), averaged
over every batch of the window, traced or not.  Layer:
ops/photon.propagate."""


def read(ctx):
    parts = [p for p in (ctx['traced'], ctx['rest']) if p]
    steps = [s for p in parts for _, s, _ in p['counters'].propagations
             if s]
    return sum(steps) / len(steps) if steps else None

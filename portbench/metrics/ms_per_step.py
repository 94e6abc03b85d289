"""Host time a step of the step loop (ms): the untraced rest of the
window over every step in it.  The profiler, which slows the host, is
off there.  Layer: ops/photon.propagate."""


def read(ctx):
    rest = ctx['rest']
    if not rest:
        return None
    steps = sum(s for _, s, _ in rest['counters'].propagations if s)
    return 1000.0 * rest['window_s'] / steps if steps else None

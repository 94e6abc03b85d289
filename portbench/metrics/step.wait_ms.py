"""Host ms the step loop waits a step for the device: the step's one
sync, its live-photon list (the program's span ``step.live``), over the
untraced rest of the window.  Layer: ops/photon.propagate."""
from portbench.program_spans import instrument, totals  # noqa: F401


def read(ctx):
    t = totals(ctx['rest'])
    if not t or 'step.live' not in t:
        return None
    n, total_ns, _ = t['step.live']
    return total_ns / 1e6 / n

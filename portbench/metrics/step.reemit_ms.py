"""Host ms the step loop spends a step issuing the bulk reemission of
``physics_update`` (the program's span ``step.reemit``, a child of
``step.physics``): component choice, reemission draws and the new
direction, wavelength and time, over the steps of the untraced rest of
the window.  Layer: ops/propagate.physics_update."""
from portbench.program_spans import instrument, totals  # noqa: F401


def read(ctx):
    t = totals(ctx['rest'])
    if not t or 'step.reemit' not in t or 'step.physics' not in t:
        return None
    return t['step.reemit'][1] / 1e6 / t['step.physics'][0]

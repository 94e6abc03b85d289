"""Host ms the step loop spends issuing a step's device work: its draws,
the live rows' gather, the NaN guard and walk, the physics and the
scatter back (the program's spans ``step.draw``, ``step.gather``,
``step.walk``, ``step.physics``, ``step.scatter``), over the steps of the
untraced rest of the window.  Layer: ops/photon.propagate."""
from portbench.program_spans import instrument, totals  # noqa: F401

SPANS = ('step.draw', 'step.gather', 'step.walk', 'step.physics',
         'step.scatter')


def read(ctx):
    t = totals(ctx['rest'])
    if not t or 'step.physics' not in t:
        return None
    steps = t['step.physics'][0]
    return sum(t[s][1] for s in SPANS if s in t) / 1e6 / steps

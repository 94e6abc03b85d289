"""The program's own spans and counters (``chroma_tpu_torch.tracing``),
read by the metrics of ``metrics/simulate.*``, ``metrics/step.*`` and
``metrics/photon_steps_per_photon.py``.

Each part of a traced run records into a recorder of its own,
``counters.program``, and the program's profiler ranges are named as the
harness's spans (``portbench.<span>``): ``trace.summarize`` keeps their
device-side copies out of the busy union and puts each idle gap down to
the innermost of them.  A program without the tracing module records
nothing, and its metrics read None.
"""
from portbench import spans


def instrument(counters):
    """The recorder of this part and the range names, once a part (the
    metrics share them): ``patched`` targets."""
    if hasattr(counters, 'program'):
        return []
    try:
        from chroma_tpu_torch import tracing
    except ImportError:
        counters.program = None
        return []
    counters.program = tracing.Recorder()
    return [(tracing, 'recorder', lambda _: counters.program),
            (tracing, 'open_range', lambda _: spans.span)]


def totals(part):
    """{span: (count, total_ns, self_ns)} of a part, or None."""
    rec = getattr(part['counters'], 'program', None) if part else None
    return rec.totals() if rec is not None else None


def per_call_ms(ctx, name):
    """Host ms a call of the untraced rest spent in the span ``name``."""
    rest = ctx['rest']
    t = totals(rest)
    if not t or name not in t or not rest['calls']:
        return None
    return t[name][1] / 1e6 / rest['calls']

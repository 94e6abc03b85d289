"""``physics_kernel_share``: the program's counter
``step.physics_kernel_photons`` over ``step.live_photons`` in the
untraced rest of a traced run; None where either is missing (a program
without the physics kernel, or a run on the plain path) or no part was
left untraced."""
import types

from portbench import plugins


def _reader():
    return plugins.find(plugins.BENCH_DIR, 'metrics', 'physics_kernel_share')


def _ctx(counts):
    from chroma_tpu_torch import tracing
    rec = tracing.Recorder()
    for name, n in counts.items():
        rec.counts[name] = n
    part = dict(counters=types.SimpleNamespace(program=rec))
    return dict(traced=part, rest=part, trace={})


def test_reads_the_two_counters():
    ctx = _ctx({'step.live_photons': 4000,
                'step.physics_kernel_photons': 4000})
    assert _reader().read(ctx) == 1.0
    ctx = _ctx({'step.live_photons': 4000,
                'step.physics_kernel_photons': 1000})
    assert _reader().read(ctx) == 0.25


def test_none_without_them():
    read = _reader().read
    assert read(_ctx({'step.live_photons': 4000})) is None
    assert read(_ctx({'step.physics_kernel_photons': 10})) is None
    assert read(_ctx({})) is None
    assert read(dict(traced=None, rest=None, trace={})) is None
    none = dict(counters=types.SimpleNamespace(program=None))
    assert read(dict(traced=none, rest=none, trace={})) is None

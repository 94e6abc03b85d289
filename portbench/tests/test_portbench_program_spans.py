"""The program's own spans and counters in a traced run on the CPU (the
tiny SNO-like cell of ``tinytree``): the five metrics that read them,
the program's tracing off again after the run, and nothing recorded
outside the window's parts (the warm-up call)."""
import itertools
import math
import os

import pytest

from portbench import harness, spans
from portbench.tests import tinytree

SEED = 2 ** 31 + 91
METRICS = ('simulate.join_ms', 'simulate.debatch_ms', 'step.wait_ms',
           'step.enqueue_ms', 'photon_steps_per_photon')


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp('bench')
    cache = tmp_path_factory.mktemp('cache')
    old = os.environ.get('CHROMA_TPU_CACHE')
    os.environ['CHROMA_TPU_CACHE'] = str(cache)
    saved = harness.CACHE_DIR
    harness.CACHE_DIR = str(cache)
    yield tinytree.make_tree(str(d))
    harness.CACHE_DIR = saved
    if old is None:
        del os.environ['CHROMA_TPU_CACHE']
    else:
        os.environ['CHROMA_TPU_CACHE'] = old


def test_traced_run_reads_the_program_spans(tree, monkeypatch):
    from chroma_tpu_torch import tracing
    parts = []

    class Counters(spans.Counters):
        def __init__(self):
            super().__init__()
            parts.append(self)

    ticks = itertools.count()
    monkeypatch.setattr(harness, 'clock', lambda: float(next(ticks)))
    monkeypatch.setattr(spans, 'Counters', Counters)
    c = harness.Cell(tinytree.SNO, tree)
    r = harness.run(c, SEED, 8.0, trace=True, device='cpu')
    assert r['correct'] is True
    m = r['metrics']
    for name in METRICS:
        assert name in m and math.isfinite(m[name]['value']), name
    assert m['photon_steps_per_photon']['value'] >= 1.0
    assert tracing.recorder is None
    assert tracing.open_range.__module__ == tracing.__name__
    # each part records its own calls and nothing else: the warm-up
    # call, before the window, is in neither
    assert len(parts) == 2
    for part in parts:
        t = part.program.totals()
        assert t['simulate.join'][0] == len(part.propagations) > 0
        assert t['step.physics'][0] == sum(s for _, s, _ in
                                           part.propagations)
    assert not any(n.startswith(spans.PREFIX + 'step.')
                   for n, _ in r['breakdown']['device_ops'])

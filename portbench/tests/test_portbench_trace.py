"""The trace reader's busy time and idle gaps against a brute force."""
import random

import numpy as np
import pytest

from portbench import trace


@pytest.mark.parametrize('seed', range(20))
def test_busy_and_idle_match_a_brute_force(monkeypatch, seed):
    rng = random.Random(seed)
    spans = []
    for k in range(rng.randint(0, 4)):
        a = rng.randint(0, 900)
        spans.append(('portbench.s%d' % k, False, a, a + rng.randint(1, 200)))
    devs = [('k%d' % rng.randint(0, 3), True, a, a + rng.randint(1, 80))
            for a in [rng.randint(-50, 1000) for _ in range(rng.randint(0, 40))]]
    events = [('portbench.window', False, 0, 1000)] + spans + devs
    monkeypatch.setattr(trace, '_raw_events', lambda prof: events)
    r = trace.summarize(None)
    busy = np.zeros(1000, dtype=bool)
    for _, _, a, b in devs:
        if b > 0:
            busy[max(a, 0):min(b, 1000)] = True
    assert r['busy_s'] * 1e9 == pytest.approx(busy.sum())
    assert sum(r['idle'].values()) * 1e9 == pytest.approx(1000 - busy.sum())
    assert r['window_s'] == pytest.approx(1e-6)


def test_a_gap_goes_to_the_innermost_span(monkeypatch):
    events = [('portbench.window', False, 0, 1000),
              ('portbench.call', False, 0, 1000),
              ('portbench.propagate', False, 200, 600),
              ('k', True, 0, 300), ('k', True, 500, 1000)]
    monkeypatch.setattr(trace, '_raw_events', lambda prof: events)
    r = trace.summarize(None)
    assert r['idle'] == {'propagate': pytest.approx(200e-9)}
    assert r['busy_s'] == pytest.approx(800e-9)

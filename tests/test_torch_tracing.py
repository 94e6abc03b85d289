"""chroma_tpu_torch.tracing, the program's spans and counters, on the CPU
on a small scene (a 1,000 mm black sphere around one PMT cube):

* off (the default), ``span`` hands out one shared no-op and records
  nothing, and the step loop gives the same state bit for bit on or off;
* the step loop records one ``step.live`` a step, plus the check that
  finds no photon left when the batch drains before ``max_steps``, and
  five enqueue spans a step, each a child of ``simulate.propagate``;
  ``step.live_photons`` sums the live photons of every step;
* ``simulate`` records one join, upload, propagate, hits and daq a
  batch and one debatch an event, none of them open while the caller
  holds an event; the batch's split adds no debatch span;
* self time is the duration less the direct children's; a replaced
  ``open_range`` sees every span; the lane-pool driver records one
  ``pass.service`` a service pass (``last_stats[0]``);
* with the sphere filled with a scintillator of two reemitting
  components, the step loop opens one ``step.reemit`` a step under
  ``step.physics`` and gives the same state on or off, and
  ``simulate.reemitted`` equals the batches' ``BULK_REEMIT`` end flags;
  in water no ``step.reemit`` opens and nothing is counted;
* on the CPU the physics kernel serves no step:
  ``step.physics_kernel_photons`` is not counted.
"""
import collections
import contextlib
import time

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax  # noqa: F401  (imported before torch, as the test files do)
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu_torch import event, gpu, host, tracing
from chroma_tpu_torch.ops import photon as photon_ops
from chroma_tpu_torch.ops.propagate import alive_mask
from chroma_tpu_torch.sim import Simulation
from tests import torch_scenes

ENQUEUE = ('step.draw', 'step.gather', 'step.walk', 'step.physics',
           'step.scatter')
BATCH = ('simulate.join', 'simulate.upload', 'simulate.propagate',
         'simulate.hits', 'simulate.daq')


@pytest.fixture(scope='module')
def scene():
    return gpu.GPUDetector(torch_scenes.water_scene(), 'cpu')


@pytest.fixture(scope='module')
def scint_scene():
    return gpu.GPUDetector(torch_scenes.scint_scene(), 'cpu')


def _bombs(sizes, seed=17):
    np.random.seed(seed)
    return [host.photon_bomb(n, 400.0, (0.0, 0.0, 0.0)).photons_beg
            for n in sizes]


def _counts(rec):
    return collections.Counter(name for name, _, _, _ in rec.spans)


def _propagate(scene, ph, **kw):
    gp = gpu.GPUPhotons(ph, 'cpu', copy_triangles=False,
                        copy_weights=False)
    gp.propagate(scene, gpu.get_rng_states(seed=3, device='cpu'), **kw)
    return gp


def test_off_hands_out_one_shared_noop(monkeypatch):
    assert tracing.recorder is None
    first = tracing.span('step.live')
    assert tracing.span('simulate.join') is first

    def forbidden(*args):
        raise AssertionError('called while tracing is off')
    monkeypatch.setattr(tracing, 'open_range', forbidden)
    monkeypatch.setattr(tracing.time, 'perf_counter_ns', forbidden)
    with first, tracing.span('pass.wait'):
        tracing.count('step.live_photons', 5)
    with tracing.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}
    assert tracing.recorder is None


def test_recording_restores_the_previous_recorder():
    with tracing.recording() as outer:
        with tracing.span('a'):
            with tracing.recording() as inner:
                with tracing.span('b'):
                    tracing.count('n', 2)
            assert tracing.recorder is outer
        tracing.count('n', 1)
    assert tracing.recorder is None
    assert [(n, p) for n, p, _, _ in outer.spans] == [('a', None)]
    assert [(n, p) for n, p, _, _ in inner.spans] == [('b', None)]
    assert outer.counts == {'n': 1} and inner.counts == {'n': 2}


def test_step_loop_is_bit_equal_on_and_off(scene):
    ph = _bombs([600])[0]
    off = _propagate(scene, ph, driver='steps')
    with tracing.recording() as rec:
        on = _propagate(scene, ph, driver='steps')
    assert _counts(rec)['step.physics'] == on.last_steps == off.last_steps
    for k, v in off.state.items():
        a, b = v.numpy(), on.state[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


def test_step_loop_with_reemission_is_bit_equal_on_and_off(scint_scene):
    ph = _bombs([600])[0]
    off = _propagate(scint_scene, ph, driver='steps')
    with tracing.recording() as rec:
        on = _propagate(scint_scene, ph, driver='steps')
    counts = _counts(rec)
    assert counts['step.reemit'] == counts['step.physics'] == on.last_steps
    assert {p for n, p, _, _ in rec.spans if n == 'step.reemit'} \
        == {'step.physics'}
    flags = off.state['flags'].numpy().view(np.uint32)
    assert ((flags & event.BULK_REEMIT) != 0).sum() > 100
    for k, v in off.state.items():
        a, b = v.numpy(), on.state[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


def test_cpu_step_loop_counts_no_kernel_photons(scint_scene):
    """On the CPU the physics runs in the plain version: the step loop
    counts its live photons and nothing under
    ``step.physics_kernel_photons``."""
    with tracing.recording() as rec:
        _propagate(scint_scene, _bombs([300])[0], driver='steps')
    assert rec.counts['step.live_photons'] >= 300
    assert 'step.physics_kernel_photons' not in rec.counts


def test_reemitted_counts_the_bulk_reemit_end_flags(scint_scene):
    """``simulate.reemitted`` sums each batch's photons that end with
    ``BULK_REEMIT``: two batches of two events."""
    sim = Simulation(scint_scene, seed=9, driver='steps')
    with tracing.recording() as rec:
        events = list(sim.simulate(_bombs([300] * 4), run_daq=True,
                                   keep_photons_end=True,
                                   photons_per_batch=600))
    flags = np.concatenate([ev.photons_end.flags for ev in events])
    want = int(((flags & event.BULK_REEMIT) != 0).sum())
    assert want > 100
    assert rec.counts['simulate.reemitted'] == want
    assert _counts(rec)['simulate.hits'] == 2


def test_water_opens_no_reemit_span_and_counts_nothing(scene):
    sim = Simulation(scene, seed=9, driver='steps')
    with tracing.recording() as rec:
        list(sim.simulate(_bombs([300, 300]), run_daq=True))
    assert _counts(rec)['step.physics'] > 0
    assert 'step.reemit' not in _counts(rec)
    assert 'simulate.reemitted' not in rec.counts


@pytest.mark.parametrize('max_steps', [2, 100])
def test_step_spans_under_simulate(scene, monkeypatch, max_steps):
    """At 2 steps the batch is still live at the end; at 100 it drains,
    and one more ``step.live`` finds nothing."""
    steps, live = [], []
    orig_propagate = gpu.GPUPhotons.propagate
    orig_step = photon_ops.propagate_step

    def propagate(self, *args, **kwargs):
        out = orig_propagate(self, *args, **kwargs)
        steps.append(self.last_steps)
        return out

    def step(sub, *args, **kwargs):
        live.append(int(alive_mask(sub['flags']).sum()))
        return orig_step(sub, *args, **kwargs)
    monkeypatch.setattr(gpu.GPUPhotons, 'propagate', propagate)
    monkeypatch.setattr(photon_ops, 'propagate_step', step)
    sim = Simulation(scene, seed=9, driver='steps')
    with tracing.recording() as rec:
        events = list(sim.simulate(_bombs([300, 300]), run_daq=True,
                                   max_steps=max_steps))
    assert len(events) == 2 and len(steps) == 1
    n = steps[0]
    drained = n < max_steps
    assert drained == (max_steps == 100)
    counts = _counts(rec)
    assert counts['step.live'] == n + drained
    for name in ENQUEUE:
        assert counts[name] == n, name
    for name, parent, _, _ in rec.spans:
        if name.startswith('step.'):
            assert parent == 'simulate.propagate', name
        if name.startswith('simulate.'):
            assert parent is None, name
    assert len(live) == n and min(live) > 0
    assert rec.counts['step.live_photons'] == sum(live)


def test_simulate_spans_a_batch_and_an_event(scene):
    """Three events of 300 photons at 500 photons a batch: a batch of
    two events and one of one."""
    sim = Simulation(scene, seed=9, driver='steps')
    with tracing.recording() as rec:
        events = list(sim.simulate(_bombs([300, 300, 300]), run_daq=True,
                                   photons_per_batch=500))
    assert len(events) == 3
    counts = _counts(rec)
    for name in BATCH:
        assert counts[name] == 2, name
    assert counts['simulate.debatch'] == 3
    totals = rec.totals()
    for name, (n, total, own) in totals.items():
        assert n == counts[name] and 0 <= own <= total, name


@pytest.mark.parametrize('per_batch', [1, 4])
def test_the_batch_split_adds_no_debatch_span(scene, per_batch):
    """The batch's split runs inside its first event's span: one
    ``simulate.debatch`` an event, with one event a batch or four."""
    sim = Simulation(scene, seed=9, driver='steps')
    with tracing.recording() as rec:
        events = list(sim.simulate(_bombs([150] * 4), run_daq=True,
                                   photons_per_batch=150 * per_batch))
    counts = _counts(rec)
    assert len(events) == 4
    assert counts['simulate.hits'] == 4 // per_batch
    assert counts['simulate.debatch'] == 4
    assert rec.counts.get('simulate.debatch_resorted', 0) == 0


def test_a_consumer_holding_an_event_adds_nothing(scene):
    sleep_s = 0.3
    sim = Simulation(scene, seed=9, driver='steps')
    with tracing.recording() as rec:
        for _ in sim.simulate(_bombs([200, 200, 200]), run_daq=True):
            time.sleep(sleep_s)
    debatch = [(s, e) for n, _, s, e in rec.spans
               if n == 'simulate.debatch']
    assert len(debatch) == 3
    for (s0, e0), (s1, e1) in zip(debatch, debatch[1:]):
        assert e0 - s0 < sleep_s * 1e9 and s1 - e0 >= sleep_s * 1e9


def test_self_time_is_total_less_direct_children(monkeypatch):
    clock = iter(range(0, 10 ** 6, 10))
    monkeypatch.setattr(tracing.time, 'perf_counter_ns',
                        lambda: next(clock))
    with tracing.recording() as rec:
        with tracing.span('a'):
            with tracing.span('b'):
                with tracing.span('c'):
                    pass
            with tracing.span('b'):
                pass
        with tracing.span('b'):
            pass
    dur = collections.defaultdict(int)
    child = collections.defaultdict(int)
    for name, parent, s, e in rec.spans:
        dur[name] += e - s
        if parent is not None:
            child[parent] += e - s
    t = rec.totals()
    assert t['a'] == (1, 70, 70 - 40)
    assert t['b'] == (3, dur['b'], dur['b'] - child['b'])
    assert t['c'] == (1, 10, 10)
    for name, (n, total, own) in t.items():
        assert own == total - child[name], name


def test_a_replaced_open_range_sees_every_span(scene, monkeypatch):
    opened = []

    def open_range(name):
        opened.append(name)
        return contextlib.nullcontext()
    monkeypatch.setattr(tracing, 'open_range', open_range)
    sim = Simulation(scene, seed=9, driver='steps')
    with tracing.recording() as rec:
        list(sim.simulate(_bombs([200, 200]), run_daq=True))
    assert sorted(opened) == sorted(n for n, _, _, _ in rec.spans)
    assert set(opened) >= set(BATCH) | set(ENQUEUE) | {
        'simulate.debatch', 'step.live'}


def test_default_range_is_named_after_the_package():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.recording():
            with tracing.span('step.live'):
                torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert 'chroma_tpu_torch.step.live' in names


@pytest.mark.parametrize('kw', [dict(), dict(service_frac=0.5)],
                         ids=['static', 'dynamic'])
def test_fused_driver_records_a_service_span_a_pass(scene, kw):
    with tracing.recording() as rec:
        gp = _propagate(scene, _bombs([700])[0], width=256, **kw)
    counts = _counts(rec)
    passes = int(gp.last_stats[0])
    assert passes > 0 and counts['pass.service'] == passes
    assert counts['pass.walk'] >= passes and counts['pass.wait'] >= passes
    for name, parent, _, _ in rec.spans:
        assert name.startswith('pass.') and parent is None, name

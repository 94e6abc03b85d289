"""``Simulation.simulate``'s de-batching against a plain per-event mask,
on the CPU, on a small scene (a 1,000 mm black sphere around four PMT
cubes, none below the centre).

Each batch's flat hits (``GPUPhotons.get_flat_hits``), channels
(``ops/daq.run_daq``, or the sharded path's combined channels) and end
state (``GPUPhotons.get``) are captured as the program makes them; the
expected events are cut from them the way a mask does it: the rows of
``evidx == i``, then of ``channel == c`` for each distinct channel, and
each event's slice of the channel block.  Every event's ``flat_hits``,
``hits``, ``channels`` and ``photons_end`` must be equal to them bit for
bit, with their dtypes, on every driver, with and without ``keep_hits``,
with events of unequal sizes and one that detects nothing; and each
event owns its arrays.  ``_split_by`` is held against a mask split on
shuffled keys, and ``simulate.debatch_resorted`` counts the batches
that needed its sort: none on any driver, one when the flat hits come
back shuffled.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu_torch import event, gpu, host, parallel, tracing
from chroma_tpu_torch import sim as sim_module
from chroma_tpu_torch.ops import daq as daq_ops
from chroma_tpu_torch.sim import Simulation, _split_by

FIELDS = ('pos', 'dir', 'pol', 'wavelengths', 't', 'last_hit_triangles',
          'flags', 'weights', 'evidx', 'channel')

# photons a bomb event, and one event of photons aimed away from the
# PMT, into the black sphere: it detects nothing
SIZES = (300, 40, 700, 5)
DARK = 3

DRIVERS = {
    'steps': dict(driver='steps'),
    'steps_sorted': dict(driver='steps', driver_options=dict(sort_every=1)),
    'compacting': dict(driver='compacting'),
    'fused': dict(driver='fused', driver_options=dict(width=256)),
    'fused_mesh': dict(driver='fused', driver_options=dict(width=256),
                       devices=['cpu', 'cpu']),
}


def _scene():
    from chroma_tpu_torch import make
    from chroma_tpu_torch.demo import optics
    from chroma_tpu_torch.detector import Detector
    from chroma_tpu_torch.geometry import Solid
    det = Detector(optics.water)
    det.add_solid(Solid(make.sphere(1000.0, nsteps=24), optics.water,
                        optics.water, surface=optics.black_surface))
    for at in ((0, 0, 500.0), (500.0, 0, 0), (0, 500.0, 0), (-500.0, 0, 0)):
        det.add_pmt(Solid(make.cube(300.0), optics.water, optics.water,
                          surface=optics.r7081hqe_photocathode),
                    displacement=at)
    det.set_time_dist_gaussian(1.5, -7.5, 7.5)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.0, 1.5)
    det.flatten()
    return det


@pytest.fixture(scope='module')
def scene():
    return gpu.GPUDetector(_scene(), 'cpu')


def _events(seed=17):
    np.random.seed(seed)
    out = []
    for k, n in enumerate(SIZES):
        ph = host.photon_bomb(n, 400.0, (0.0, 0.0, 0.0)).photons_beg
        if k == DARK:
            ph.dir[:] = (0.0, 0.0, -1.0)
            ph.pol[:] = (1.0, 0.0, 0.0)
        out.append(ph)
    return out


class Capture(object):
    """Each batch's flat hits, channels and end state, as copies."""

    def __init__(self, monkeypatch, shuffle=False):
        self.hits, self.channels, self.ends = [], [], []
        inside_sharded = []
        orig_hits = gpu.GPUPhotons.get_flat_hits
        orig_get = gpu.GPUPhotons.get
        orig_daq = daq_ops.run_daq
        orig_sharded = parallel.propagate_and_daq_sharded

        def get_flat_hits(gp, *args, **kwargs):
            out = orig_hits(gp, *args, **kwargs)
            if shuffle:
                rng = np.random.RandomState(5)
                out = out[rng.permutation(len(out))]
            self.hits.append(out[np.arange(len(out))])
            return out

        def get(gp):
            out = orig_get(gp)
            self.ends.append(out[np.arange(len(out))])
            return out

        def keep(channels):
            self.channels.append({k: v.clone() for k, v in channels.items()})
            return channels

        def run_daq(*args, **kwargs):
            out = orig_daq(*args, **kwargs)
            return out if inside_sharded else keep(out)

        def sharded(*args, **kwargs):
            inside_sharded.append(True)
            try:
                state, channels = orig_sharded(*args, **kwargs)
            finally:
                inside_sharded.pop()
            return state, keep(channels)
        monkeypatch.setattr(gpu.GPUPhotons, 'get_flat_hits', get_flat_hits)
        monkeypatch.setattr(gpu.GPUPhotons, 'get', get)
        monkeypatch.setattr(daq_ops, 'run_daq', run_daq)
        monkeypatch.setattr(parallel, 'propagate_and_daq_sharded', sharded)

    def expected(self, batches, nch, keep_hits):
        """Per event: (flat_hits, hits, channels, photons_end), cut by
        masks from the captured batches."""
        out = []
        for b, sizes in enumerate(batches):
            flat = self.hits[b]
            bounds = np.cumsum([0] + list(sizes))
            ch = self.channels[b]
            t = ch['t'].numpy()
            q = ch['q'].numpy()
            flags = ch['flags'].numpy().view(np.uint32)
            for i in range(len(sizes)):
                ev_hits = flat[flat.evidx == i]
                hits = {int(c): ev_hits[ev_hits.channel == c]
                        for c in np.unique(ev_hits.channel)} \
                    if keep_hits else None
                sl = slice(i * nch, (i + 1) * nch)
                channels = event.Channels(t[sl] < 1e8, t[sl], q[sl],
                                          flags[sl])
                end = self.ends[b][bounds[i]:bounds[i + 1]]
                out.append((ev_hits, hits, channels, end))
        return out


def _same_array(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), what


def _same_photons(a, b, what):
    assert len(a) == len(b), what
    for f in FIELDS:
        _same_array(getattr(a, f), getattr(b, f), '%s.%s' % (what, f))


def _owns(photons, what):
    for f in FIELDS:
        assert getattr(photons, f).flags.owndata, '%s.%s' % (what, f)


def _run(scene, monkeypatch, driver, keep_hits, photons_per_batch,
         shuffle=False):
    cap = Capture(monkeypatch, shuffle=shuffle)
    kw = dict(DRIVERS[driver])
    sim = Simulation(scene, seed=9, **kw)
    with tracing.recording() as rec:
        events = list(sim.simulate(
            _events(), keep_photons_end=True, keep_hits=keep_hits,
            run_daq=True, photons_per_batch=photons_per_batch))
    # the batches simulate makes: events until photons_per_batch
    batches, cur, n = [], [], 0
    for size in SIZES:
        cur.append(size)
        n += size
        if n >= photons_per_batch:
            batches.append(cur)
            cur, n = [], 0
    if cur:
        batches.append(cur)
    assert len(cap.hits) == len(cap.channels) == len(batches)
    return events, cap.expected(batches, scene.nchannels, keep_hits), rec


@pytest.mark.parametrize('keep_hits', [True, False],
                         ids=['hits', 'flat_only'])
@pytest.mark.parametrize('driver', sorted(DRIVERS))
def test_events_equal_a_mask_split(scene, monkeypatch, driver, keep_hits):
    """Two batches: the first holds three events of unequal sizes, the
    second the dark event alone."""
    events, expected, rec = _run(scene, monkeypatch, driver, keep_hits,
                                 photons_per_batch=1000)
    assert len(events) == len(expected) == len(SIZES)
    assert len(events[0].flat_hits) > 0
    assert len(np.unique(events[2].flat_hits.channel)) > 1
    assert len(events[DARK].flat_hits) == 0
    for k, (ev, (flat, hits, channels, end)) in enumerate(
            zip(events, expected)):
        what = 'event %d' % k
        _same_photons(ev.flat_hits, flat, what + ' flat_hits')
        _owns(ev.flat_hits, what + ' flat_hits')
        if keep_hits:
            assert list(ev.hits) == list(hits), what
            for c in hits:
                _same_photons(ev.hits[c], hits[c], '%s hits[%d]' % (what, c))
        else:
            assert ev.hits is None
        for f in ('hit', 't', 'q', 'flags'):
            _same_array(getattr(ev.channels, f), getattr(channels, f),
                        '%s channels.%s' % (what, f))
            assert getattr(ev.channels, f).base is None, what
        _same_photons(ev.photons_end, end, what + ' photons_end')
    assert rec.counts.get('simulate.debatch_resorted', 0) == 0


def test_one_batch_of_every_event(scene, monkeypatch):
    """All four events, the dark one last, in one batch."""
    events, expected, rec = _run(scene, monkeypatch, 'steps', True,
                                 photons_per_batch=10 ** 6)
    assert len(events) == len(SIZES)
    for k, (ev, (flat, hits, channels, end)) in enumerate(
            zip(events, expected)):
        _same_photons(ev.flat_hits, flat, 'event %d' % k)
        assert list(ev.hits) == list(hits)
        for c in hits:
            _same_photons(ev.hits[c], hits[c], 'event %d hits' % k)
        _same_array(ev.channels.t, channels.t, 'event %d t' % k)
    assert rec.counts.get('simulate.debatch_resorted', 0) == 0


def test_shuffled_flat_hits_are_sorted_once(scene, monkeypatch):
    """Flat hits handed back out of event order: one sort, counted, and
    each event's rows in the order its mask gives them."""
    events, expected, rec = _run(scene, monkeypatch, 'steps', True,
                                 photons_per_batch=10 ** 6, shuffle=True)
    assert rec.counts['simulate.debatch_resorted'] == 1
    for k, (ev, (flat, hits, _, _)) in enumerate(zip(events, expected)):
        _same_photons(ev.flat_hits, flat, 'event %d' % k)
        _owns(ev.flat_hits, 'event %d' % k)
        assert list(ev.hits) == list(hits)
        for c in hits:
            _same_photons(ev.hits[c], hits[c], 'event %d hits' % k)


@pytest.mark.parametrize('n', [0, 1, 7])
@pytest.mark.parametrize('sort', [True, False], ids=['sorted', 'shuffled'])
def test_split_by_equals_a_mask_split(n, sort):
    rng = np.random.RandomState(11 + n)
    keys = rng.randint(0, n + 2, size=500).astype(np.uint32)
    if sort:
        keys = np.sort(keys, kind='stable')
    order, bounds = _split_by(keys, n)
    assert (order is None) == bool(np.all(keys[1:] >= keys[:-1]))
    assert len(bounds) == n + 1
    rows = np.arange(len(keys)) if order is None else order
    for k in range(n):
        _same_array(rows[bounds[k]:bounds[k + 1]], np.flatnonzero(keys == k),
                    'key %d' % k)


def test_by_channel_equals_a_mask_per_channel():
    rng = np.random.RandomState(3)
    n = 400
    hits = event.Photons(pos=rng.rand(n, 3), dir=rng.rand(n, 3),
                         pol=rng.rand(n, 3), wavelengths=rng.rand(n),
                         t=rng.rand(n), channel=rng.randint(0, 90, size=n))
    got = sim_module._by_channel(hits)
    want = {int(c): hits[hits.channel == c] for c in np.unique(hits.channel)}
    assert list(got) == list(want)
    for c in want:
        _same_photons(got[c], want[c], 'channel %d' % c)
    assert sim_module._by_channel(hits[:0]) == {}

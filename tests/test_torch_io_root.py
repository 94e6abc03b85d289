"""The port's ROOT and ntuple event IO (chroma_tpu_torch/io/root.py,
io/ntuple.py) under the fake PyROOT and uproot/awkward of tests/ (no
machine here has ROOT or uproot), in the shapes of
tests/test_root_contract.py and tests/test_ntuple_contract.py.

Besides each round trip, the port's writers must fill exactly the
branches and rows the JAX package's writers fill from the same events
(tolerance: none), and each package's reader must read the other's file.
"""
import importlib
import sys

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax  # noqa: F401  (imported before torch, as the test files do)
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import event as jevent
from chroma_tpu.generator.photon import photon_bomb as jphoton_bomb
from chroma_tpu_torch import event as pevent
from chroma_tpu_torch.generator.photon import photon_bomb as pphoton_bomb

PACKAGES = {'port': (pevent, pphoton_bomb, 'chroma_tpu_torch'),
            'jax': (jevent, jphoton_bomb, 'chroma_tpu')}


def fresh(monkeypatch, module, fakes):
    """Import ``module`` anew with ``fakes`` ({name: module or None}) in
    sys.modules."""
    for name, fake in fakes.items():
        monkeypatch.setitem(sys.modules, name, fake)
    monkeypatch.delitem(sys.modules, module, raising=False)
    mod = importlib.import_module(module)
    monkeypatch.delitem(sys.modules, module)
    return mod


@pytest.fixture()
def rootio(monkeypatch):
    import tests.fake_root as fr
    fake = fr.make_fake()
    return {k: fresh(monkeypatch, pkg + '.io.root', {'ROOT': fake})
            for k, (_, _, pkg) in PACKAGES.items()}, fr


@pytest.fixture()
def ntio(monkeypatch):
    import tests.fake_uproot as fu
    uproot, awkward = fu.make_fakes()
    mods = {k: fresh(monkeypatch, pkg + '.io.ntuple',
                     {'uproot': uproot, 'awkward': awkward})
            for k, (_, _, pkg) in PACKAGES.items()}
    fu.FILES.clear()
    return mods, fu


def make_event(which, i, hits=True):
    """tests/test_root_contract.py's event, from either package."""
    event, photon_bomb, _ = PACKAGES[which]
    np.random.seed(100 + i)
    ev = photon_bomb(20, 450.0, (1.0, 2.0, 3.0), t0=float(i))
    ev.id = i
    ev.vertices = [event.Vertex('e-', (0, 0, 0), (0, 0, 1), 5.0, t0=0.5)]
    ev.photons_end = ev.photons_beg[::2]
    ev.flat_hits = ev.photons_beg[:5]
    ev.flat_hits.channel = np.arange(5, dtype=np.uint32)
    if hits:
        ev.hits = {2: ev.photons_beg[:3], 7: ev.photons_beg[3:5]}
    ev.channels = event.Channels(
        hit=np.array([True, False, True]),
        t=np.array([1.5, 1e9, 2.5], np.float32),
        q=np.array([1.0, 0.0, 2.0], np.float32),
        flags=np.array([4, 0, 4], np.uint32))
    return ev


class Det(object):
    channel_index_to_position = np.arange(9, dtype=float).reshape(3, 3)
    channel_index_to_channel_type = np.array([1, 1, 2])


def root_snapshot(fr):
    return {name: [dict(e) for e in tree._entries]
            for name, tree in fr._TREES.items()}


def test_root_round_trip(rootio, tmp_path):
    mods, _ = rootio
    path = str(tmp_path / 'events.root')
    w = mods['port'].RootWriter(path)
    events = [make_event('port', 0), make_event('port', 1)]
    for ev in events:
        w.write_event(ev)
    w.close()
    r = mods['port'].RootReader(path)
    assert len(r) == 2
    for i, ev in enumerate(events):
        back = r.read_event(i)
        assert isinstance(back, pevent.Event) and back.id == ev.id
        for f in ('pos', 'dir', 'pol', 'wavelengths', 't'):
            np.testing.assert_allclose(getattr(back.photons_beg, f),
                                       getattr(ev.photons_beg, f), rtol=1e-6)
        np.testing.assert_array_equal(back.photons_beg.flags,
                                      ev.photons_beg.flags)
        assert len(back.photons_end) == len(ev.photons_end)
        np.testing.assert_allclose(back.flat_hits.t, ev.flat_hits.t,
                                   rtol=1e-6)
        assert sorted(back.hits) == [2, 7]
        np.testing.assert_allclose(back.hits[7].pos, ev.hits[7].pos,
                                   rtol=1e-6)
        v = back.vertices[0]
        assert v.particle_name == 'e-' and v.ke == 5.0 and v.t0 == 0.5
        for f in ('hit', 'flags'):
            np.testing.assert_array_equal(getattr(back.channels, f),
                                          getattr(ev.channels, f))
        np.testing.assert_allclose(back.channels.q, ev.channels.q)
    assert r.next().id == 0 and r.next().id == 1
    assert r.prev().id == 0 and r.current().id == 0


def test_root_files_match_jax(rootio, tmp_path):
    """The same branches and rows from both writers (channel-info tree
    included), and each reader reads the other's file."""
    mods, fr = rootio
    snaps = {}
    for which in ('jax', 'port'):
        w = mods[which].RootWriter(str(tmp_path / (which + '.root')),
                                   detector=Det())
        for i in range(2):
            w.write_event(make_event(which, i, hits=i == 0))
        w.close()
        snaps[which] = root_snapshot(fr)
        # the other package reads this file (the fake keeps the last)
        other = 'port' if which == 'jax' else 'jax'
        back = [mods[other].RootReader(str(tmp_path / (which + '.root')))
                .read_event(i) for i in range(2)]
        assert [ev.id for ev in back] == [0, 1]
        assert sorted(back[0].hits) == [2, 7] and back[1].hits is None
        assert np.array_equal(back[1].photons_end.flags,
                              make_event(which, 1).photons_end.flags)
    assert snaps['port'] == snaps['jax']
    ch = snaps['port']['CH'][0]
    assert ch['channel_pos'] == list(np.arange(9.0))
    assert ch['channel_type'] == [1, 1, 2]


def test_missing_root_raises_with_pointer(tmp_path, monkeypatch):
    mod = fresh(monkeypatch, 'chroma_tpu_torch.io.root', {'ROOT': None})
    assert not mod.HAVE_ROOT
    with pytest.raises(ImportError, match='npz'):
        mod.RootWriter(str(tmp_path / 'x.root'))


def deep_equal(a, b):
    import tests.fake_uproot as fu
    if isinstance(a, fu.Record):
        return isinstance(b, fu.Record) and deep_equal(a.fields, b.fields)
    if isinstance(a, fu.Array):
        return isinstance(b, fu.Array) and deep_equal(a.rows, b.rows)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(deep_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(deep_equal(x, y)
                                        for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


def test_ntuple_schema(ntio, tmp_path):
    mods, fu = ntio
    path = str(tmp_path / 'events.ntuple')
    with mods['port'].NTupleWriter(path, detector=Det(),
                                   write_mcphotons=True) as w:
        for i in range(2):
            w.write_event(make_event('port', i))
    f = fu.FILES[path]
    assert f.closed
    md = f.trees['metadata']
    np.testing.assert_array_equal(md['n_channels'], [3])
    np.testing.assert_allclose(md['ch_pos_z'][0], [2.0, 5.0, 8.0])
    np.testing.assert_array_equal(md['ch_types'][0], [1, 1, 2])
    evs = f.trees['events']
    np.testing.assert_array_equal(evs['evid'], [0, 1])
    for i in range(2):
        vtx = evs['vertex'][i]
        np.testing.assert_array_equal(vtx['pdg'], [11])
        np.testing.assert_allclose(vtx['ke'], [5.0])
        beg = evs['photons_beg'][i]
        assert len(beg) == 20
        np.testing.assert_allclose(beg['t'], np.full(20, float(i)))
        np.testing.assert_allclose(beg['wavelength'], np.full(20, 450.0))
        assert len(evs['photons_end'][i]) == 10
        np.testing.assert_array_equal(evs['mcpe'][i]['channel'],
                                      np.arange(5))
        hit = evs['hit'][i]
        np.testing.assert_array_equal(hit['pmt'], [0, 2])
        np.testing.assert_allclose(hit['time'], [1.5, 2.5])


@pytest.mark.parametrize('mcphotons', [False, True])
def test_ntuple_files_match_jax(ntio, tmp_path, mcphotons):
    """Both writers make the same trees from the same events, padded
    rows included (an event without vertices or a readout)."""
    mods, fu = ntio
    trees = {}
    for which in ('jax', 'port'):
        path = str(tmp_path / (which + '.ntuple'))
        ev1 = make_event(which, 1)
        ev1.vertices = []
        ev1.channels = None
        with mods[which].NTupleWriter(path, detector=Det(),
                                      write_mcphotons=mcphotons) as w:
            w.write_event(make_event(which, 0))
            w.write_event(ev1)
        trees[which] = fu.FILES[path].trees
    assert deep_equal(trees['port'], trees['jax'])
    evs = trees['port']['events']
    assert len(evs['vertex'][1]) == 0 and len(evs['hit'][1]) == 0
    assert ('photons_beg' in evs) == mcphotons


def test_missing_uproot_raises_with_pointer(tmp_path, monkeypatch):
    mod = fresh(monkeypatch, 'chroma_tpu_torch.io.ntuple',
                {'uproot': None, 'awkward': None})
    assert not mod.HAVE_UPROOT
    with pytest.raises(ImportError, match='npz'):
        mod.NTupleWriter(str(tmp_path / 'x.ntuple'))

"""The port's three command-line paths on the CPU, and the formats they
share with the JAX package: the npz event file (either package reads the
other's, every field equal), the propagation server's two protocols
(``pack``/``unpack`` byte-equal to the JAX package's, ``answer`` and a
real REQ/REP round trip), and ``main(argv)`` of the sim and cam
commands with ``--device cpu``.
"""
import sys
import threading
import uuid

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax  # noqa: F401  (imported before torch, as the test files do)
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import event as jevent
from chroma_tpu.cli.server import ChromaRATServer as JChromaRATServer
from chroma_tpu.io import npz as jnpz
from chip_smoke import rat_reply, rat_request
from chroma_tpu_torch import event as pevent, host
from chroma_tpu_torch.cli import bvh as cli_bvh, cam as cli_cam, \
    geo as cli_geo, server as cli_server, sim as cli_sim
from chroma_tpu_torch.cli.server import ChromaRATServer, ChromaServer
from chroma_tpu_torch.generator.photon import HAVE_ZMQ
from chroma_tpu_torch.io import npz as pnpz

needs_zmq = pytest.mark.skipif(not HAVE_ZMQ, reason='pyzmq missing')

PHOTON_FIELDS = ('pos', 'dir', 'pol', 'wavelengths', 't', 'flags',
                 'weights', 'evidx', 'last_hit_triangles', 'channel')
STEP_FIELDS = ('x', 'y', 'z', 't', 'dx', 'dy', 'dz', 'ke', 'edep', 'qedep')


def small_detector():
    """One cubic PMT inside a black sphere of water (the scene of
    tests/test_render.py's event viewer); the commands load it as
    ``@tests.test_torch_cli.small_detector``."""
    from chroma_tpu_torch.detector import Detector
    from chroma_tpu_torch.demo.optics import water, \
        r7081hqe_photocathode, black_surface
    det = Detector(water)
    det.add_solid(host.Solid(host.make.sphere(1000.0, nsteps=16), water,
                             water, surface=black_surface))
    det.add_pmt(host.Solid(host.make.cube(200.0), water, water,
                           surface=r7081hqe_photocathode),
                displacement=(0, 0, 600.0))
    det.set_time_dist_gaussian(1.5, -7.5, 7.5)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.0, 1.5)
    return det


# ---- the npz event file -----------------------------------------------

def _photons(ev, rng, n, channel=False):
    unit = rng.normal(size=(n, 3))
    return ev.Photons(
        pos=rng.normal(size=(n, 3)) * 100.0, dir=unit, pol=unit[:, ::-1],
        wavelengths=rng.uniform(300.0, 600.0, n), t=rng.uniform(0, 50, n),
        last_hit_triangles=rng.randint(-1, 1000, n).astype(np.int32),
        flags=rng.randint(0, 2 ** 31, n).astype(np.uint32) * 2 + 1,
        weights=rng.uniform(0, 1, n),
        evidx=rng.randint(0, 4, n).astype(np.uint32),
        channel=rng.randint(0, 9, n).astype(np.uint32) if channel else None)


def _event(ev, seed):
    """An Event with every field the file stores, from one seed."""
    rng = np.random.RandomState(seed)
    steps = ev.Steps(*[rng.normal(size=5).astype(np.float32)
                       for _ in STEP_FIELDS])   # stored as float32
    child = ev.Vertex('gamma', rng.normal(size=3), rng.normal(size=3), 2.5,
                      t0=0.3, trackid=7)
    vertex = ev.Vertex('e-', rng.normal(size=3), rng.normal(size=3), 10.0,
                       t0=1.0, steps=steps, children=[child], trackid=1)
    flat = _photons(ev, rng, 6, channel=True)
    return ev.Event(
        id=seed, vertices=[vertex], photons_beg=_photons(ev, rng, 20),
        photons_end=_photons(ev, rng, 20),
        photon_tracks=[_photons(ev, rng, 3), _photons(ev, rng, 2)],
        hits={int(c): flat[flat.channel == c]
              for c in np.unique(flat.channel)},
        flat_hits=flat,
        channels=ev.Channels(rng.rand(9) > 0.5, rng.uniform(0, 50, 9),
                             rng.uniform(0, 3, 9),
                             rng.randint(0, 2 ** 31, 9).astype(np.uint32)))


def _same_photons(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for f in PHOTON_FIELDS:
        x, y = getattr(a, f, None), getattr(b, f, None)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def _same_vertex(a, b):
    assert (a.particle_name, a.trackid, a.pdgcode) \
        == (b.particle_name, b.trackid, b.pdgcode)
    for f in ('pos', 'dir', 'ke', 't0'):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f
    assert (a.steps is None) == (b.steps is None)
    if a.steps is not None:
        for f in STEP_FIELDS:
            assert np.array_equal(getattr(a.steps, f), getattr(b.steps, f))
    assert len(a.children or []) == len(b.children or [])
    for x, y in zip(a.children or [], b.children or []):
        _same_vertex(x, y)


def _same_event(a, b):
    assert a.id == b.id
    for f in ('photons_beg', 'photons_end', 'flat_hits'):
        _same_photons(getattr(a, f), getattr(b, f))
    assert len(a.photon_tracks) == len(b.photon_tracks)
    for x, y in zip(a.photon_tracks, b.photon_tracks):
        _same_photons(x, y)
    assert sorted(a.hits) == sorted(b.hits)
    for c in a.hits:
        _same_photons(a.hits[c], b.hits[c])
    for f in ('hit', 't', 'q', 'flags'):
        assert np.array_equal(getattr(a.channels, f), getattr(b.channels, f))
    assert len(a.vertices) == len(b.vertices)
    for x, y in zip(a.vertices, b.vertices):
        _same_vertex(x, y)


@pytest.mark.parametrize('writer,reader', [
    ('port', 'jax'), ('jax', 'port'), ('port', 'port')])
def test_npz_file_crosses_the_packages(tmp_path, writer, reader):
    mods = {'jax': (jnpz, jevent), 'port': (pnpz, pevent)}
    wmod, wevent = mods[writer]
    rmod, revent = mods[reader]
    path = str(tmp_path / 'events.npz')
    with wmod.NpzWriter(path) as w:
        for seed in (3, 4):
            w.write_event(_event(wevent, seed))
    r = rmod.NpzReader(path)
    assert len(r) == 2
    for i, ev in enumerate(r):
        assert isinstance(ev, revent.Event)
        assert isinstance(ev.photons_end, revent.Photons)
        _same_event(ev, _event(revent, 3 + i))


def test_npz_channel_info(tmp_path):
    """``set_detector`` stores the channel positions both readers find."""
    det = small_detector()
    det.flatten()
    path = str(tmp_path / 'det.npz')
    with pnpz.NpzWriter(path) as w:
        w.set_detector(det)
        w.write_event(_event(pevent, 1))
    a, b = pnpz.NpzReader(path).channel_info, \
        jnpz.NpzReader(path).channel_info
    assert a is not None and sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k])


# ---- the server -------------------------------------------------------

def _box():
    geo = host.Geometry(host.vacuum)
    geo.add_solid(host.Solid(host.make.box(100, 100, 100), host.vacuum,
                             host.vacuum))
    return geo


def test_rat_pack_unpack_byte_equal_to_jax():
    rng = np.random.RandomState(12)
    msg = rat_request(_photons(pevent, rng, 40), 77)
    jph, jid = JChromaRATServer.unpack(msg)
    pph, pid = ChromaRATServer.unpack(msg)
    assert int(jid) == int(pid) == 77 and isinstance(pph, pevent.Photons)
    for f in ('pos', 'dir', 'pol', 'wavelengths', 't'):
        assert np.array_equal(getattr(jph, f), getattr(pph, f)), f
    chan = np.sort(rng.randint(0, 9, 40)).astype(np.uint32)
    assert ChromaRATServer.pack(pph, chan, pid) \
        == JChromaRATServer.pack(jph, chan, jid)


def test_server_answer_without_a_socket():
    """``address=None``: no socket, no pyzmq; ``answer`` does the work of
    one request in both protocols."""
    np.random.seed(71)
    photons = host.photon_bomb(500, 400.0, (0, 0, 0)).photons_beg
    server = ChromaServer(None, _box(), device='cpu')
    assert server.socket is None
    end = server.answer(photons)
    assert isinstance(end, pevent.Photons) and len(end) == 500
    assert ((end.flags & pevent.NO_HIT) > 0).mean() >= 0.99
    assert not np.allclose(end.pos, photons.pos)
    server.close()

    rat = ChromaRATServer(None, small_detector(), device='cpu')
    np.random.seed(72)
    photons = host.photon_bomb(3000, 400.0, (0, 0, 300.0)).photons_beg
    reply = rat.answer(rat_request(photons, 9))
    eventid, body, chan = rat_reply(reply)
    assert eventid == 9 and 0 < len(chan) < 3000
    assert body.shape == (len(chan), 11) and np.isfinite(body).all()
    assert len(reply) == 8 + 88 * len(chan) + 8 * len(chan)
    assert (chan == 0).all()      # the one PMT is channel 0
    rat.close()


@needs_zmq
def test_server_round_trip():
    """A real REQ/REP round trip through ``serve_forever`` (the shape of
    tests/test_generator.py's server test)."""
    import zmq
    # unique per run: a stale server bound to the same ipc path would
    # race for the requests
    address = 'ipc:///tmp/chroma_tpu_torch_test_server_' + uuid.uuid4().hex
    server = ChromaServer(address, _box(), device='cpu')
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    ctx = zmq.Context()
    sock = ctx.socket(zmq.REQ)
    sock.connect(address)
    try:
        np.random.seed(71)
        photons = host.photon_bomb(500, 400.0, (0, 0, 0)).photons_beg
        for _ in range(2):
            sock.send_pyobj(photons)
            assert sock.poll(120000), 'server did not answer'
            photons_end = sock.recv_pyobj()
            assert len(photons_end) == 500
            no_hit = (photons_end.flags & pevent.NO_HIT) > 0
            assert no_hit.mean() >= 0.99, no_hit.mean()
            assert not np.allclose(photons_end.pos, photons.pos)
    finally:
        sock.close(linger=0)
        ctx.term()


# ---- main(argv) -------------------------------------------------------

DETECTOR = '@tests.test_torch_cli.small_detector'


@needs_zmq
def test_cli_sim_writes_a_readable_file(tmp_path, capsys):
    out = str(tmp_path / 'gun.npz')
    cli_sim.main([DETECTOR, '-o', out, '-n', '3', '-k', '5', '-s', '4',
                  '--pos', '0,0,300', '--dir', '0,0,1',
                  '--save-photons-end', '--device', 'cpu'])
    assert 'Wrote 3 events' in capsys.readouterr().out
    reader = pnpz.NpzReader(out)
    assert len(reader) == 3
    events = list(reader)
    assert sorted(ev.id for ev in events) == [0, 1, 2]
    for ev in events:
        assert len(ev.photons_end) > 0 and ev.photons_beg is None
        assert ev.channels is not None and len(ev.channels.hit) == 1
        assert ev.vertices[0].particle_name == 'e-'
    assert any(ev.channels.hit.any() for ev in events)
    assert reader.channel_info is not None
    assert len(list(jnpz.NpzReader(out))) == 3


def test_cli_sim_names_the_missing_root_writer(tmp_path, monkeypatch):
    """``.root`` output goes through the ntuple writer, as in the JAX
    package; without uproot it raises, naming the npz format, before
    any event is simulated."""
    monkeypatch.setitem(sys.modules, 'uproot', None)
    monkeypatch.setitem(sys.modules, 'awkward', None)
    monkeypatch.delitem(sys.modules, 'chroma_tpu_torch.io.ntuple',
                        raising=False)
    out = str(tmp_path / 'out.root')
    with pytest.raises(ImportError, match='npz'):
        cli_sim.main([DETECTOR, '-o', out, '-g', '0', '--device', 'cpu'])
    monkeypatch.delitem(sys.modules, 'chroma_tpu_torch.io.ntuple')


@needs_zmq
def test_cli_sim_writes_root_through_the_ntuple_writer(tmp_path,
                                                       monkeypatch, capsys):
    """Under the fake uproot/awkward of tests/fake_uproot.py: the gun's
    events and the detector's channels land in the ntuple trees."""
    import tests.fake_uproot as fu
    uproot, awkward = fu.make_fakes()
    monkeypatch.setitem(sys.modules, 'uproot', uproot)
    monkeypatch.setitem(sys.modules, 'awkward', awkward)
    monkeypatch.delitem(sys.modules, 'chroma_tpu_torch.io.ntuple',
                        raising=False)
    fu.FILES.clear()
    out = str(tmp_path / 'gun.root')
    cli_sim.main([DETECTOR, '-o', out, '-n', '3', '-k', '5', '-s', '4',
                  '--pos', '0,0,300', '--dir', '0,0,1', '--device', 'cpu'])
    monkeypatch.delitem(sys.modules, 'chroma_tpu_torch.io.ntuple')
    assert 'Wrote 3 events to %s' % out in capsys.readouterr().out
    f = fu.FILES[out]
    assert f.closed
    np.testing.assert_array_equal(f.trees['metadata']['n_channels'], [1])
    evs = f.trees['events']
    assert sorted(evs['evid']) == [0, 1, 2]
    assert all(len(v) == 1 for v in evs['vertex'].rows)
    assert all(len(m) > 0 for m in evs['mcpe'].rows)
    assert all(set(h['pmt']) <= {0} for h in evs['hit'].rows)


@pytest.mark.parametrize('extra', [[], ['--bvh-layer', '1'], ['--hybrid']])
def test_cli_cam_writes_a_png(tmp_path, extra):
    from PIL import Image
    out = str(tmp_path / 'view.png')
    cli_cam.main([DETECTOR, '-o', out, '--size', '48x36', '--device', 'cpu']
                 + extra)
    img = np.asarray(Image.open(out))
    assert img.shape == (36, 48, 3)
    if '--hybrid' not in extra:
        assert (img != 0x66).any()


@needs_zmq
def test_cli_cam_event_viewer(tmp_path):
    """``-i``: the event viewer over a file the sim command wrote."""
    from PIL import Image
    events = str(tmp_path / 'gun.npz')
    cli_sim.main([DETECTOR, '-o', events, '-n', '1', '-k', '5', '-s', '4',
                  '--pos', '0,0,300', '--dir', '0,0,1', '--device', 'cpu'])
    out = str(tmp_path / 'event.png')
    cli_cam.main([DETECTOR, '-i', events, '-o', out, '--size', '48x36',
                  '--tracks', '--device', 'cpu'])
    assert np.asarray(Image.open(out)).shape == (36, 48, 3)


def test_cli_server_parser_has_a_device(monkeypatch):
    """``main`` builds the server on the device named; without a card and
    without ``--device`` it raises, naming the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_server.main([DETECTOR, '-a', 'ipc:///tmp/chroma_tpu_torch_none_'
                         + uuid.uuid4().hex])


# ---- chroma-torch-geo and chroma-torch-bvh on a temporary cache ----------

@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv('CHROMA_TPU_CACHE', str(tmp_path / 'cache'))
    return tmp_path / 'cache'


def test_cli_geo_commands(cache_dir, capsys):
    """save / list / stat / default / remove on a cache of its own."""
    from chroma_tpu_torch.cache import Cache
    cli_geo.main(['save', DETECTOR, 'small'])
    assert 'saved geometry small' in capsys.readouterr().out
    assert (cache_dir / 'torch_geo' / 'small').exists()
    cli_geo.main(['save', '@chroma_tpu_torch.models.companioncube'])
    cli_geo.main(['list'])
    out = capsys.readouterr().out.split()
    assert out[-2:] == ['companioncube', 'small']
    cli_geo.main(['stat', 'small'])
    stat = capsys.readouterr().out
    geometry = Cache().load_geometry('small')
    assert 'triangles: %d' % len(geometry.mesh.triangles) in stat
    assert 'vertices:  %d' % len(geometry.mesh.vertices) in stat
    assert 'channels:  1' in stat
    assert 'mesh hash: %s' % geometry.mesh.md5() in stat
    cli_geo.main(['default', 'small'])
    assert 'default geometry set to small' in capsys.readouterr().out
    assert len(Cache().load_default_geometry().mesh.triangles) \
        == len(geometry.mesh.triangles)
    cli_geo.main(['remove', 'companioncube'])
    cli_geo.main(['list'])
    # the list shows the default's link beside the geometries, as the
    # JAX package's does
    assert capsys.readouterr().out.split() == ['.default', 'small']


def test_cli_bvh_commands(cache_dir, capsys):
    """create / stat / list / optimize / remove, the created BVH
    bit-equal to the JAX package's builder on the same mesh, and the
    optimized one its ``area_sort_children``."""
    from chroma_tpu import bvh as jbvh
    from chroma_tpu.bvh.optimize import area_sort_children as jsort
    from chroma_tpu_torch.cache import Cache
    cli_geo.main(['save', DETECTOR, 'small'])
    cli_bvh.main(['create', 'small:grid3', '3'])
    assert 'Creating degree 3 BVH' in capsys.readouterr().out
    cache = Cache()
    mesh = cache.load_geometry('small').mesh
    mesh_hash = cache.get_geometry_hash('small')
    bvh = cache.load_bvh(mesh_hash, 'grid3')
    want = jbvh.make_recursive_grid_bvh(mesh, target_degree=3)
    assert np.array_equal(jbvh.from_uint4(bvh.nodes),
                          jbvh.from_uint4(want.nodes))
    assert list(bvh.layer_offsets) == list(want.layer_offsets)

    cli_bvh.main(['stat', 'small:grid3'])
    stat = capsys.readouterr().out
    assert 'nodes:  %d' % len(bvh) in stat
    assert 'layers: %d' % bvh.layer_count() in stat
    assert stat.count('area = ') == bvh.layer_count()
    cli_bvh.main(['optimize', 'small:grid3', '-o', 'sorted'])
    assert 'optimized in' in capsys.readouterr().out
    got = cache.load_bvh(mesh_hash, 'sorted')
    assert np.array_equal(jbvh.from_uint4(got.nodes),
                          jbvh.from_uint4(jsort(want).nodes))
    cli_bvh.main(['list', 'small'])
    listed = capsys.readouterr().out
    assert 'grid3' in listed and 'sorted' in listed
    cli_bvh.main(['remove', 'small:sorted'])
    cli_bvh.main(['list', 'small'])
    assert 'sorted' not in capsys.readouterr().out
    assert cli_bvh.parse_bvh_id('small') == ('small', 'default')
    assert cli_bvh.parse_bvh_id('small:') == ('small', 'default')

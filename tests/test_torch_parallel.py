"""chroma_tpu_torch.parallel, photon-axis sharding over a device list,
against the JAX package and against each shard run by hand, on CPU
meshes (``['cpu', 'cpu']``, ``['cpu'] * 3``).

* ``pad_to_multiple`` gives the JAX package's padded state bit for bit
  (flags and evidx as the int32 bits of its uint32 words);
* ``GPUPhotons.propagate(mesh=...)`` equals each shard propagated by
  hand with its ``shard_generator``, bit for bit, with ragged shards
  (641 photons over 2 shards: one padding photon and 321 lanes a shard;
  over 3: 214), and with a shard made only of padding (2 photons over
  3), which passes through in one service pass unchanged;
* ``propagate_and_daq_sharded``'s channels equal the numpy min, sum and
  OR of each shard's ``run_daq`` run by hand: t and flags bit-equal
  (the history word's sign bit included), q bit-equal over 2 shards and
  within 1 ulp a term over 3 (numpy may add in another order);
* a sharded ``Simulation`` against the JAX package's single-device one
  on tests/test_parallel.py's scene (a 1,000 mm black sphere, one PMT
  cube), 4,096 photons, max_steps 30: hit counts within 5 sigma
  (Poisson), mean hit time within 0.5 ns, one hit channel on both
  sides, ``photons_end`` in upload order; ``eval_pdf`` on the mesh
  against the port's single-device ``eval_pdf``, hitcount within 6
  sigma; a mesh of one device equal to no mesh bit for bit; the step
  loop refuses a mesh.

The JAX package's own sharded functions compile shard_map over its
fused driver, which is slow on the CPU (its mesh tests are marked
slow); its single-device Simulation is the reference here, and its own
slow test holds its mesh path to that.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax  # noqa: F401  (imported before torch, as the test files do)
import jax.numpy as jnp
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import parallel as jparallel
from chroma_tpu_torch import event, gpu, host, parallel
from chroma_tpu_torch.ops import daq as daq_ops
from chroma_tpu_torch.ops import fused
from chroma_tpu_torch.ops.propagate import TERMINAL
from chroma_tpu_torch.sim import Simulation

MAX_STEPS = 30
FIELDS = ('pos', 'dir', 'pol', 'wavelength', 't', 'weight', 'flags',
          'last_hit_triangle', 'evidx', 'index')


@pytest.fixture(scope='module')
def tiny():
    det = host.demo.tiny()
    det.flatten()
    return gpu.GPUDetector(det, 'cpu')


def _bomb(n, seed):
    np.random.seed(seed)
    return host.photon_bomb(n, 400.0, (200.0, 0.0, 0.0)).photons_beg


def _assert_bit_equal(a, b, what):
    for k in FIELDS:
        x, y = a[k].numpy(), b[k].numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), (what, k)


@pytest.mark.parametrize('n,multiple', [(641, 2), (641, 3), (5, 3),
                                        (6, 3), (2, 3)])
def test_pad_to_multiple_matches_jax(n, multiple):
    """The padded state bit for bit against chroma_tpu.parallel's, the
    port's int32 flag and evidx words as the JAX package's uint32 bits,
    its int64 index as the JAX uint32 index."""
    ph = _bomb(n, 7)
    state = gpu.GPUPhotons(ph, 'cpu').state
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    for k in ('flags', 'evidx'):
        jstate[k] = jnp.asarray(state[k].numpy().view(np.uint32))
    jstate['index'] = jnp.arange(n, dtype=jnp.uint32)
    got, gn = parallel.pad_to_multiple(state, multiple)
    want, wn = jparallel.pad_to_multiple(jstate, multiple)
    assert gn == wn == n
    assert got['pos'].shape[0] == n + (-n % multiple)
    for k in FIELDS:
        w = np.asarray(want[k])
        g = got[k].numpy()
        if k == 'index':
            assert g.dtype == np.int64
            assert np.array_equal(g, w.astype(np.int64)), k
            continue
        if w.dtype == np.uint32:
            assert g.dtype == np.int32, k
            g = g.view(np.uint32)
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    pad = got['flags'][n:]
    assert ((pad & TERMINAL) != 0).all()
    assert (got['evidx'][n:] == -1).all()
    assert (got['weight'][n:] == 0).all()


@pytest.mark.parametrize('nshards,n', [(2, 641), (3, 641), (3, 2)])
def test_sharded_propagation_equals_shards_by_hand(tiny, nshards, n):
    """GPUPhotons.propagate(mesh=...) against each shard propagated by
    hand with ``shard_generator(seed, d, 'cpu')`` from the seed that
    ``RNGStream.next()`` hands out: every field bit-equal, stats summed.
    A shard made only of padding comes back unchanged after one service
    pass."""
    ph = _bomb(n, 11)
    mesh = parallel.make_photon_mesh(['cpu'] * nshards)
    assert mesh.size == nshards and mesh.axis_names == ('photons',)
    p = gpu.GPUPhotons(ph, 'cpu')
    p.propagate(tiny, gpu.get_rng_states(seed=4, device='cpu'),
                max_steps=MAX_STEPS, mesh=mesh)
    assert len(p) == n

    seed = gpu.get_rng_states(seed=4, device='cpu').next()
    state, _ = parallel.pad_to_multiple(gpu.GPUPhotons(ph, 'cpu').state,
                                        nshards)
    m = state['pos'].shape[0] // nshards
    assert m % 32 or m < 32        # the lanes of a shard: a ragged width
    outs, stats = [], []
    for d in range(nshards):
        shard = {k: v[d * m:(d + 1) * m] for k, v in state.items()}
        out, st = fused.propagate_fused(
            shard, tiny.geom, fused.uniform_draws(
                parallel.shard_generator(seed, d, 'cpu')),
            max_steps=MAX_STEPS)
        if d * m >= n:             # padding only
            _assert_bit_equal(out, shard, 'padding shard %d' % d)
            assert int(st[0]) == 1
        outs.append(out)
        stats.append(st.numpy())
    ref = {k: torch.cat([o[k] for o in outs])[:n] for k in FIELDS}
    _assert_bit_equal(p.state, ref, '%d shards' % nshards)
    assert np.array_equal(p.last_stats, np.sum(stats, axis=0))
    assert np.array_equal(p.state['index'].numpy(), np.arange(n))
    term = (p.state['flags'] & TERMINAL) != 0
    assert term.float().mean() >= 0.9


def _detected_terminal_photons(tiny, ph, k):
    """``ph`` with every k-th photon made terminal on arrival: detected on
    a channel's triangle with NAN_ABORT (bit 31, the int32 sign bit) in
    its history, so the DAQ records it as it is."""
    channel_of = tiny.det.solid_id_to_channel_index[
        tiny.geom.solid_id_map.long()]
    tri = int(torch.nonzero(channel_of >= 0)[0])
    flags = np.asarray(ph.flags, np.uint32)
    flags[::k] = event.SURFACE_DETECT | event.NAN_ABORT
    ph.flags = flags
    lht = np.asarray(ph.last_hit_triangles, np.int32)
    lht[::k] = tri
    ph.last_hit_triangles = lht
    return ph


@pytest.mark.parametrize('nshards', [2, 3])
def test_sharded_daq_reduction_matches_numpy(tiny, nshards):
    """propagate_and_daq_sharded over 2 events and 2 DAQ copies: each
    shard propagated and digitized by hand (one shard generator, the
    DAQ block after the propagation's), then t by np.minimum, q by
    np.sum and flags by np.bitwise_or over the shards."""
    n, ndaq, nevents = 641, 2, 2
    ph = _detected_terminal_photons(tiny, _bomb(n, 13), 50)
    ph.evidx = (np.arange(n) % nevents).astype(np.uint32)
    mesh = parallel.make_photon_mesh(['cpu'] * nshards)
    state, _ = parallel.pad_to_multiple(gpu.GPUPhotons(ph, 'cpu').state,
                                        nshards)
    nch = tiny.nchannels
    out, got = parallel.propagate_and_daq_sharded(
        state, tiny, 99, mesh, nch, max_steps=MAX_STEPS, ndaq=ndaq,
        nevents=nevents)
    assert out['pos'].shape[0] == state['pos'].shape[0]

    m = state['pos'].shape[0] // nshards
    chans = []
    for d in range(nshards):
        shard = {k: v[d * m:(d + 1) * m] for k, v in state.items()}
        gen = parallel.shard_generator(99, d, 'cpu')
        o, _ = fused.propagate_fused(shard, tiny.geom,
                                     fused.uniform_draws(gen),
                                     max_steps=MAX_STEPS)
        _assert_bit_equal({k: out[k][d * m:(d + 1) * m] for k in FIELDS},
                          o, 'shard %d' % d)
        u = daq_ops.daq_draws(gen, ndaq, m)
        chans.append({k: v.numpy() for k, v in daq_ops.run_daq(
            o, tiny.geom, tiny.det, u, nch, ndaq=ndaq,
            nevents=nevents).items()})
    t = np.minimum.reduce([c['t'] for c in chans])
    q = np.sum([c['q'] for c in chans], axis=0)
    flags = np.bitwise_or.reduce([c['flags'] for c in chans])
    assert got['t'].numpy().view(np.uint32).tolist() \
        == t.view(np.uint32).tolist()
    assert np.array_equal(got['flags'].numpy(), flags)
    if nshards == 2:
        assert np.array_equal(got['q'].numpy().view(np.uint32),
                              q.view(np.uint32))
    else:
        np.testing.assert_array_max_ulp(got['q'].numpy(), q,
                                        maxulp=nshards - 1)
    hit = t < 1e8
    assert hit.any() and (t[~hit] == np.float32(1e9)).all()
    assert (flags[hit] & event.SURFACE_DETECT).all()
    assert (flags < 0).any()       # NAN_ABORT: bit 31 survived the OR
    assert got['t'].shape == (nevents * ndaq * nch,)


def test_reduce_channels_keeps_unhit_and_sign_bit():
    """The reduction alone: an unhit channel (t = 1e9 in every shard)
    stays 1e9, and the OR keeps bit 31 of the int32 history word."""
    rng = np.random.RandomState(3)
    nch = 64
    chans = []
    for d in range(3):
        t = np.where(rng.rand(nch) < 0.5, rng.uniform(0, 50, nch),
                     1e9).astype(np.float32)
        t[:4] = 1e9
        flags = rng.randint(0, 1 << 12, nch).astype(np.uint32)
        flags[d::5] |= np.uint32(event.NAN_ABORT)
        chans.append(dict(t=t, q=rng.uniform(0, 3, nch).astype(np.float32),
                          flags=flags.view(np.int32)))
    got = parallel.reduce_channels(
        [{k: torch.from_numpy(v) for k, v in c.items()} for c in chans],
        torch.device('cpu'))
    t = np.minimum.reduce([c['t'] for c in chans])
    assert np.array_equal(got['t'].numpy(), t)
    assert (got['t'].numpy()[:4] == np.float32(1e9)).all()
    assert np.array_equal(got['q'].numpy(),
                          (chans[0]['q'] + chans[1]['q']) + chans[2]['q'])
    flags = np.bitwise_or.reduce([c['flags'].view(np.uint32)
                                  for c in chans])
    assert np.array_equal(got['flags'].numpy().view(np.uint32), flags)
    assert (flags & np.uint32(event.NAN_ABORT)).any()


def _sphere_scene(make, Solid, Detector, optics):
    """tests/test_parallel.py's scene, built with either package."""
    det = Detector(optics.water)
    det.add_solid(Solid(make.sphere(1000.0, nsteps=24), optics.water,
                        optics.water, surface=optics.black_surface))
    det.add_pmt(Solid(make.cube(300.0), optics.water, optics.water,
                      surface=optics.r7081hqe_photocathode),
                displacement=(0, 0, 500.0))
    det.set_time_dist_gaussian(1.5, -7.5, 7.5)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.0, 1.5)
    return det


def _port_scene():
    from chroma_tpu_torch import make
    from chroma_tpu_torch.demo import optics
    from chroma_tpu_torch.detector import Detector
    from chroma_tpu_torch.geometry import Solid
    return _sphere_scene(make, Solid, Detector, optics)


def _sphere_bomb(bomb, n=4096):
    """The bomb of tests/test_parallel.py with a wavelength ramp, which
    water keeps, so ``photons_end`` shows the upload order."""
    np.random.seed(17)
    ph = bomb(n, 400.0, (0, 0, 0)).photons_beg
    ph.wavelengths = np.linspace(380.0, 420.0, n).astype(np.float32)
    return ph


def test_sharded_simulation_matches_jax_single_device():
    from chroma_tpu import make
    from chroma_tpu.demo import optics
    from chroma_tpu.detector import Detector
    from chroma_tpu.generator.photon import photon_bomb
    from chroma_tpu.geometry import Solid
    from chroma_tpu.sim import Simulation as JaxSimulation
    n = 4096
    jsim = JaxSimulation(_sphere_scene(make, Solid, Detector, optics),
                         geant4_processes=0, seed=5)
    ev_j = next(jsim.simulate([_sphere_bomb(photon_bomb)], run_daq=True,
                              keep_photons_end=True, max_steps=MAX_STEPS))
    sim = Simulation(_port_scene(), devices=['cpu', 'cpu'], seed=5,
                     device='cpu')
    assert sim.mesh.size == 2
    ph = _sphere_bomb(host.photon_bomb)
    ev_p = next(sim.simulate([ph], run_daq=True, keep_photons_end=True,
                             max_steps=MAX_STEPS))
    n_p, n_j = len(ev_p.flat_hits), len(ev_j.flat_hits)
    assert n_p > 0 and n_j > 0
    assert abs(n_p - n_j) < 5.0 * np.sqrt(n_p + n_j), (n_p, n_j)
    assert abs(ev_p.flat_hits.t.mean() - ev_j.flat_hits.t.mean()) < 0.5
    assert ev_p.channels.hit.sum() == ev_j.channels.hit.sum() == 1
    assert len(ev_p.photons_end) == n
    assert np.array_equal(ev_p.photons_end.wavelengths, ph.wavelengths)
    term = (ev_p.photons_end.flags & event.TERMINAL_FLAGS) != 0
    assert term.mean() >= 0.99


def test_eval_pdf_on_mesh_matches_single_device():
    """tests/test_parallel.py::test_eval_pdf_on_mesh on the port: the
    weighted, scatter-stratified propagations of eval_pdf sharded over
    two devices, hitcount within 6 sigma of the same Simulation
    unsharded."""
    sim = Simulation(_port_scene(), devices=['cpu', 'cpu'], seed=9,
                     device='cpu')
    ev = next(sim.simulate(host.photon_bomb(2000, 400.0, (0, 0, 0),
                                            t0=100.0).photons_beg,
                           run_daq=True))

    def hitcount():
        bombs = [host.photon_bomb(2000, 400.0, (0, 0, 0), t0=100.0)
                 .photons_beg for _ in range(2)]
        h, value, _ = sim.eval_pdf(ev.channels, iter(bombs), 0.5,
                                   (-0.5, 999.5), 1, (-0.5, 9.5),
                                   min_bin_content=10, nreps=2, ndaq=4)
        assert h.shape == (1,) and (value >= 0).all()
        return float(h[0])

    sharded = hitcount()
    sim.mesh = None
    single = hitcount()
    assert sharded > 0 and single > 0
    assert abs(sharded - single) < 6.0 * np.sqrt(sharded + single + 1.0)


def test_mesh_of_one_device_equals_no_mesh(tiny):
    ph = _bomb(700, 19)
    evs = []
    for devices in (None, ['cpu']):
        sim = Simulation(tiny, seed=8, devices=devices)
        assert sim.mesh is None or sim.mesh.size == 1
        evs.append(next(sim.simulate([ph], run_daq=True,
                                     keep_photons_end=True)))
    a, b = evs
    for f in ('pos', 'dir', 'pol', 'wavelengths', 't', 'flags', 'weights',
              'last_hit_triangles', 'evidx'):
        assert np.array_equal(getattr(a.photons_end, f),
                              getattr(b.photons_end, f)), f
    for f in ('hit', 't', 'q', 'flags'):
        assert np.array_equal(getattr(a.channels, f),
                              getattr(b.channels, f)), f


@pytest.mark.parametrize('run_daq', [False, True])
def test_step_loop_refuses_a_mesh(tiny, run_daq):
    sim = Simulation(tiny, seed=8, devices=['cpu', 'cpu'], driver='steps')
    with pytest.raises(ValueError, match="driver='fused'"):
        next(sim.simulate([_bomb(64, 3)], run_daq=run_daq))


def test_tables_on_copies_once_a_device(tiny):
    """GPUGeometry.tables_on: the tables themselves on their own device;
    elsewhere (here the meta device) one copy, kept, and made again once
    ``color_solids`` has replaced the tables."""
    geom, det = tiny.tables_on('cpu')
    assert geom is tiny.geom and det is tiny.det
    geom, det = tiny.tables_on('meta')
    assert geom.mbvh_rows.device.type == 'meta'
    assert det.time_icdf.device.type == 'meta'
    assert tiny.tables_on(torch.device('meta'))[0] is geom
    solids = int(tiny.geom.solid_id_map.max()) + 1
    tiny.color_solids(np.zeros(solids, bool), np.zeros(solids, np.uint32))
    assert tiny.tables_on('meta')[0] is not geom

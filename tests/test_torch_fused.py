"""chroma_tpu_torch's on-deck lane-pool driver against the JAX package's.

``ops/fused.py`` of the port is held against ``chroma_tpu/ops/fused.py``
(Pallas walker in interpret mode, ``ondeck=True``, one chain) on
demo.tiny:

* ``_pack`` gives the JAX package's 16 words, bit for bit, and the
  referee's adversarial terminal state (chroma_tpu/referee.py, rebuilt in
  numpy by chroma_tpu_torch/referee.py) passes through
  ``propagate_fused`` bit-exact;
* one service pass (``_service_ondeck``) from the same lane state, pool
  and draw block, ``od_slots`` 1 and 2: the integer words (flags,
  last-hit triangle, evidx, index), step counts, holding and live bits
  and the refill pointer are equal; the float words are within 1e-4
  relative to the largest component of their vector (about 840 ulp;
  test_torch_propagate.py's one-step bound: XLA contracts a*b+c into
  FMAs and the two packages' log, exp, arccos and sin differ);
* the whole driver, n = 768, width 256, ``service_every`` 10,
  ``max_steps`` 40: draws differ (a torch.Generator against threefry),
  so it is checked as tests/test_mbvh_pallas.py checks the JAX on-deck
  driver: order preserved, every photon terminal or moved, detections
  within Poisson of the JAX driver, photon-steps within 2x;
* the second on-deck slot drains the pool in fewer service passes and
  fewer lane-iterations at ``service_every`` 24.
"""
from functools import partial

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import demo, event, referee as jreferee
from chroma_tpu.generator.photon import photon_bomb
from chroma_tpu.ops import fused as F
from chroma_tpu.ops import geometry_pack as jgp
from chroma_tpu.ops import mbvh_pallas as MP
from chroma_tpu.ops import photon as jphoton
from chroma_tpu.ops.propagate import NDRAWS
from chroma_tpu_torch import referee
from chroma_tpu_torch.ops import fused, mbvh_walk
from chroma_tpu_torch.ops import propagate as tprop
from tests.test_torch_ondeck import _run_jax
from tests.test_torch_tables import port_tables

FLOAT_RTOL = 1e-4
# packed float words by vector: pos, dir, pol, wavelength, t, weight
_VECTORS = ((0, 3), (3, 6), (6, 9), (9, 10), (10, 11), (11, 12))


@pytest.fixture(scope='module')
def tiny():
    det = demo.tiny()
    det.flatten()
    jgeom, jdet = jgp.pack_detector(det)
    return jgeom, port_tables(jgeom, jdet)[0], det


def _port_state(jstate):
    out = {}
    for k, v in jstate.items():
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(a.astype(np.int64) if k == 'index'
                                  else a.copy())
    return out


def _bomb(n, seed, pos=(0.0, 0.0, 0.0)):
    np.random.seed(seed)
    return jphoton.upload_photons(photon_bomb(n, 400.0, pos).photons_beg)


def _assert_rows_close(ref, out):
    """ref (m, 16) uint32, out (m, 16) int32 packed photon rows."""
    ref = np.asarray(ref).view(np.int32)
    out = np.asarray(out)
    assert np.array_equal(ref[:, 12:16], out[:, 12:16])
    for lo, hi in _VECTORS:
        a = ref[:, lo:hi].view(np.float32)
        b = out[:, lo:hi].view(np.float32)
        fin = np.isfinite(a).all(axis=1)
        assert np.array_equal(fin, np.isfinite(b).all(axis=1)), (lo, hi)
        scale = np.maximum(np.abs(a[fin]).max(axis=1), 1e-30)
        assert np.all(np.abs(a[fin] - b[fin]).max(axis=1)
                      <= FLOAT_RTOL * scale), (lo, hi)


def test_pack_matches_jax():
    for jstate in (_bomb(300, 4), jreferee._adversarial_terminal_state(300)):
        ref = np.asarray(F._pack(jstate)).view(np.int32)
        out = fused._pack(_port_state(jstate)).numpy()
        assert np.array_equal(ref, out)
        back = fused._pack(fused._unpack(torch.from_numpy(out)))
        assert np.array_equal(back.numpy(), out)


def test_referee_state_matches_jax():
    ref = jreferee._adversarial_terminal_state(257)
    out = referee.adversarial_terminal_state(257)
    assert sorted(ref) == sorted(out)
    for k in ref:
        a = np.ascontiguousarray(np.asarray(ref[k]))
        assert np.array_equal(a.view(np.uint8),
                              out[k].astype(a.dtype).view(np.uint8)), k


@pytest.mark.parametrize('od_slots', [1, 2])
def test_referee_terminal_passthrough(tiny, od_slots):
    _, pgeom, _ = tiny
    assert referee.terminal_passthrough(pgeom, n=1000, width=256,
                                        od_slots=od_slots) == []


# ---- one service pass ------------------------------------------------

def _jax_window(jgeom, lane, od_slots, n_iters):
    keys = F._w_keys_od(od_slots)
    W = _run_jax(jgeom, {k[2:]: lane[k] for k in keys}, n_iters, od_slots)
    return dict(lane, **{'W_' + k: v for k, v in W.items()})


def _port_lane(lane, depth, od_slots):
    def i32(k):
        a = np.asarray(lane[k])
        return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                                 else a).copy())
    W = mbvh_walk.walker_state_from_jax(
        {k[2:]: np.asarray(lane[k]) for k in F._w_keys_od(od_slots)},
        depth, True, od_slots, 'cpu')
    out = dict(pk=i32('pk'), W=W, holding=i32('holding'), step=i32('step'))
    for pre in ('odk', 'odk2')[:od_slots]:
        out.update({pre + s: i32(pre + s)
                    for s in ('_packed', '_step', '_live')})
    return out


def run_service_pass(tiny, od_slots, use_weights=False, scatter_first=0):
    """A JAX lane set after window, service pass, window (so on-deck
    slots are filled and parked results wait), then one more service
    pass through both packages from that state with the same draws."""
    jgeom, pgeom, _ = tiny
    n, w, max_steps = 640, 128, 40
    depth = int(jgeom.mbvh_depth)
    state = dict(_bomb(n, 11), index=jnp.arange(n, dtype=jnp.uint32))
    packed = F._pack(state)
    lane = F._make_lane(state, jgeom, 0, w, depth, pal=True, ondeck=True,
                        packed=packed, od_slots=od_slots)
    svc = jax.jit(partial(F._service_ondeck, geom=jgeom, max_steps=max_steps,
                          scatter_first=scatter_first,
                          use_weights=use_weights, idx_bases=[0],
                          od_slots=od_slots))
    pools, ptrs = [packed], [jnp.asarray(w, jnp.int32)]
    keys = [jax.random.PRNGKey(7)]
    lane = _jax_window(jgeom, lane, od_slots, 12)
    lanes, pools, ptrs, keys = svc([lane], pools, ptrs, keys)
    lane = _jax_window(jgeom, lanes[0], od_slots, 12)
    start = {k: np.asarray(v) for k, v in lane.items()}

    # the port, from the same state and the same draw block
    _, sk = jax.random.split(keys[0])
    u = np.asarray(jax.random.uniform(sk, ((1 + od_slots) * w, NDRAWS),
                                      dtype=jnp.float32))
    plane = _port_lane(lane, depth, od_slots)
    pool0 = np.asarray(pools[0]).view(np.int32)
    ppool = torch.from_numpy(np.concatenate([pool0, pool0[:1] * 0]))
    pptr = fused._service_ondeck(
        plane, ppool, torch.tensor(int(ptrs[0]), dtype=torch.int64),
        lambda rows: torch.from_numpy(u[:rows].copy()), pgeom, max_steps,
        scatter_first, od_slots, use_weights)
    lanes, pools, ptrs, _ = svc([lane], pools, ptrs, keys)
    return dict(od_slots=od_slots, start=start, ref=lanes[0],
                ref_pool=pools[0], ref_ptr=int(ptrs[0]), lane=plane,
                pool=ppool, ptr=int(pptr), n=n, depth=depth)


@pytest.fixture(scope='module', params=[1, 2])
def service_pass(request, tiny):
    return run_service_pass(tiny, request.param)


def test_service_pass_sets_present(service_pass):
    """The pass starts with parked photons, live on-deck slots, drained
    walks and (two slots) second-slot parks: every set is exercised."""
    s = service_pass['start']
    pad = s['W_uregs'][MP.U_PAD]
    assert ((pad & 1) != 0).sum() > 10
    assert s['odk_live'].sum() > 10
    assert ((s['W_uregs'][MP.U_ACT] == 0) & s['holding']).sum() > 10
    if service_pass['od_slots'] == 2:
        assert ((pad & 4) != 0).sum() > 0


def test_service_pass_matches_jax(service_pass):
    assert_service_pass_matches(service_pass)


def assert_service_pass_matches(service_pass):
    p, ref, od_slots = service_pass['lane'], service_pass['ref'], \
        service_pass['od_slots']
    assert service_pass['ptr'] == service_pass['ref_ptr']
    n = service_pass['n']
    _assert_rows_close(service_pass['ref_pool'], service_pass['pool'][:n])
    for k in ('holding', 'step'):
        assert np.array_equal(np.asarray(ref[k]), p[k].numpy()), k
    _assert_rows_close(ref['pk'], p['pk'])
    for pre in ('odk', 'odk2')[:od_slots]:
        for k in (pre + '_live', pre + '_step'):
            assert np.array_equal(np.asarray(ref[k]), p[k].numpy()), k
        live = np.asarray(ref[pre + '_live'])
        _assert_rows_close(np.asarray(ref[pre + '_packed'])[live],
                           p[pre + '_packed'].numpy()[live])
    # swap bits cleared; on-deck slots seeded alike
    assert not p['W']['pad'].any()
    back = mbvh_walk.walker_state_to_jax(p['W'], service_pass['depth'],
                                         od_slots)
    for slot in ('od_', 'od2_')[:od_slots]:
        assert np.array_equal(np.asarray(ref['W_' + slot + 'uregs']),
                              back[slot + 'uregs']), slot


# ---- the whole driver --------------------------------------------------

N_DRIVER = 768


@pytest.fixture(scope='module')
def photons768():
    return _bomb(N_DRIVER, 13)


@pytest.mark.parametrize('od_slots', [1, 2])
def test_driver_matches_jax_statistically(tiny, photons768, od_slots):
    jgeom, pgeom, _ = tiny
    state = photons768
    kw = dict(max_steps=40, width=256, service_every=10, od_slots=od_slots)
    out_j, stats_j = F.propagate_fused(state, jgeom, jax.random.PRNGKey(19),
                                       use_pallas=True, ondeck=True,
                                       chains=1, **kw)
    gen = torch.Generator()
    gen.manual_seed(19)
    pstate = _port_state(state)
    out_p, stats_p = fused.propagate_fused(pstate, pgeom,
                                           fused.uniform_draws(gen), **kw)
    assert stats_p.dtype == torch.int32 and stats_p.shape == (4,)
    # order preserved; every photon terminal or moved
    assert torch.equal(out_p['index'], pstate['index'])
    assert torch.equal(out_p['evidx'], pstate['evidx'])
    flags = out_p['flags'].numpy().view(np.uint32)
    moved = ~np.isclose(out_p['t'].numpy(), pstate['t'].numpy())
    assert (((flags & event.TERMINAL_FLAGS) != 0) | moved).all()
    det_p = int(((flags & event.SURFACE_DETECT) != 0).sum())
    det_j = int(((np.asarray(out_j['flags']) & event.SURFACE_DETECT)
                 != 0).sum())
    assert abs(det_p - det_j) < 6 * max(np.sqrt(det_j + 1), 3.0), \
        (det_p, det_j)
    steps_j, steps_p = int(stats_j[1]), int(stats_p[1])
    assert 0.5 * steps_j <= steps_p <= 2 * steps_j, (steps_p, steps_j)
    assert int(stats_p[0]) > 1 and int(stats_p[2]) > 0


def test_second_slot_drains_pool_in_fewer_passes(tiny, monkeypatch):
    """With two on-deck slots a lane retires up to three photons a pass,
    so the pool runs dry in fewer service passes (9 against 6 here, for
    every generator seed tried) and fewer lane-iterations.  The total
    pass count is not compared: it is set by the last few photons of the
    tail, one physics step per pass."""
    _, pgeom, _ = tiny
    n = 4096
    state = _port_state(_bomb(n, 13))
    real = fused._service_ondeck
    passes = [0]

    def counting(lane, pool, next_ptr, *a):
        passes[0] += int(next_ptr) < n
        return real(lane, pool, next_ptr, *a)

    monkeypatch.setattr(fused, '_service_ondeck', counting)
    drain, iters = {}, {}
    for od_slots in (1, 2):
        passes[0] = 0
        gen = torch.Generator()
        gen.manual_seed(19)
        out, stats = fused.propagate_fused(
            state, pgeom, fused.uniform_draws(gen), max_steps=40, width=256,
            service_every=24, od_slots=od_slots)
        flags = out['flags'].numpy().view(np.uint32)
        assert ((flags & event.TERMINAL_FLAGS) != 0).mean() > 0.99
        assert torch.equal(out['index'], state['index'])
        drain[od_slots], iters[od_slots] = passes[0], int(stats[2])
    assert drain[2] < drain[1], drain
    assert iters[2] < iters[1], iters


def test_empty_batch_and_bad_slots(tiny):
    _, pgeom, _ = tiny
    state = tprop.make_photon_state(0, device='cpu')
    gen = torch.Generator()
    out, stats = fused.propagate_fused(state, pgeom, fused.uniform_draws(gen))
    assert out['pos'].shape == (0, 3) and stats.tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError, match='od_slots'):
        fused.propagate_fused(state, pgeom, fused.uniform_draws(gen),
                              od_slots=3)

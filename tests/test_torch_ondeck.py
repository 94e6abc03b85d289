"""chroma_tpu_torch's on-deck walker window against the JAX Pallas walker.

The port's plain window (``walk_window_plain``, the CUDA window kernel's
reference, which it runs on CPU tensors) is held against
``MP.walk_iter(..., ondeck=True)`` in interpret mode, both started from
the same walker state: a JAX ``seed`` with some lanes inactive and the
on-deck slots filled on part of the lanes, carried into the port by
``walker_state_from_jax``.  Cases: the flat sphere, instanced demo.tiny
and a ragged width (129), ``od_slots`` 1 and 2, a service window of 10
iterations and a long window in which every walk drains.

Tolerance: the integer state (pointers, flags, levels, pending codes,
bases, pad bits, triangles, materials, last-hit triangles) must be
equal, and so must the rays (a swap copies the on-deck ray and computes
1/dir and -org/dir, single operations that round alike).  The hit
floats have tests/test_torch_mbvh_walk.py's bounds: XLA on the CPU
contracts a*b+c into fused multiply-adds while the port rounds every
product (as its kernel does under --fmad=false), so distances agree
within 4e-6 relative and normals within 2e-5 of their length.  Instance registers: the rotation
is copied from the row and equal; the instance-frame origin and
direction agree within 1e-5 relative to the largest component of their
vector; their inverse and -origin/direction, where a small direction
component magnifies that difference, must be the port's own 1/idir and
-iorg/idir exactly.  The converters and the split of a window are
exact.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp
import torch

from chroma_tpu import make
from chroma_tpu.bvh.mbvh import HDR_BASE, HDR_KIND
from chroma_tpu.ops import mbvh as jmbvh
from chroma_tpu.ops import mbvh_pallas as MP
from chroma_tpu.ops.geometry_pack import pack_geometry
from chroma_tpu_torch.ops import mbvh as tmbvh
from chroma_tpu_torch.ops import mbvh_walk
from tests.test_torch_tables import port_tables

DIST_RTOL = 4e-6
NORMAL_RTOL = 2e-5
INST_RTOL = 1e-5
SHORT, LONG = 10, 200


def _pack_single(mesh):
    from tests.test_mbvh import pack_geometry_for
    return pack_geometry_for(mesh)


@pytest.fixture(scope='module')
def sphere24():
    g = _pack_single(make.sphere(50.0, nsteps=24))
    return g, port_tables(g)[0]


@pytest.fixture(scope='module')
def tiny():
    from chroma_tpu.demo import tiny as make_tiny
    geo = make_tiny()
    geo.flatten()
    g = pack_geometry(geo)
    assert g.mbvh_instanced
    return g, port_tables(g)[0]


def _dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _jax_state(jgeom, n, od_slots, seed):
    """A seeded JAX on-deck walker state: ~10% of lanes inactive, on-deck
    rays on ~2/3 of the lanes (od2 only where od1 is filled)."""
    rng = np.random.RandomState(seed)
    depth = int(jgeom.mbvh_depth)
    org = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    active = rng.rand(n) > 0.1
    W = MP.seed(jgeom, depth, jnp.asarray(org.T), jnp.asarray(_dirs(rng, n).T),
                jnp.full(n, -1, jnp.int32), jnp.asarray(active))
    W.update(MP.ondeck_empty(n, od_slots))
    valid = rng.rand(n) < 0.67
    for slot in range(1, od_slots + 1):
        o = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
        W.update(MP.od_slot_seed(jnp.asarray(o.T),
                                 jnp.asarray(_dirs(rng, n).T),
                                 jnp.full(n, -1, jnp.int32),
                                 jnp.asarray(valid), slot=slot))
        valid = valid & (rng.rand(n) < 0.6)
    return W


def _run_jax(jgeom, W, n_iters, od_slots):
    rows = jgeom.mbvh_rows
    depth = int(jgeom.mbvh_depth)
    kw = dict(ondeck=True, od_slots=od_slots, block=128,
              rbase=rows[0, HDR_BASE].astype(jnp.int32),
              rcount=(rows[0, HDR_KIND] >> jnp.uint32(8)).astype(jnp.int32),
              root_lohi=MP.root_boxes_lohi(jgeom))
    for _ in range(n_iters):
        ptr = jax.lax.bitcast_convert_type(W['uregs'][MP.U_PTR], jnp.int32)
        W = MP.walk_iter(rows[ptr].T, W, depth, bool(jgeom.mbvh_instanced),
                         jmbvh.tquant_scale(jgeom), **kw)
    return W


def _np(W):
    return {k: np.asarray(v) for k, v in W.items()}


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _run_port(pgeom, W, n_iters, od_slots):
    return tmbvh.walk_window(pgeom, W, n_iters, od_slots,
                             *mbvh_walk.root_seed_args(pgeom))


def _assert_close(ref, out, od_slots, instanced):
    """ref, out: JAX-layout numpy walker states."""
    keys = ['tcodes', 'bases', 'uregs', 'rays']
    keys += [p + k for p in ('od_', 'od2_')[:od_slots]
             for k in ('rays', 'uregs')]
    for k in keys:
        assert np.array_equal(_bits(ref[k]), _bits(out[k])), k
    hit_sets = [(ref['hregs'][0], ref['hregs'][1:4], out['hregs'][0],
                 out['hregs'][1:4])]
    for pk in ('park', 'park2')[:od_slots]:
        assert np.array_equal(_bits(ref[pk][4:6]), _bits(out[pk][4:6])), pk
        hit_sets.append((ref[pk][0], ref[pk][1:4], out[pk][0],
                         out[pk][1:4]))
    for rd, rn, od, on in hit_sets:
        fin = np.isfinite(rd)
        assert np.array_equal(fin, np.isfinite(od))
        assert np.all(np.abs(od[fin] - rd[fin]) <= DIST_RTOL * rd[fin])
        length = np.linalg.norm(rn, axis=0)
        assert np.all(np.abs(on - rn).max(axis=0) <= NORMAL_RTOL * length)
    if instanced:
        r, o = ref['iregs'], out['iregs']
        assert np.array_equal(o[0:9], r[0:9])
        for lo in (9, 12):
            scale = np.abs(r[lo:lo + 3]).max(axis=0)
            assert np.all(np.abs(o[lo:lo + 3] - r[lo:lo + 3]).max(axis=0)
                          <= INST_RTOL * scale)
        assert np.array_equal(o[15:18], np.float32(1.0) / o[12:15])
        assert np.array_equal(o[18:21], -o[9:12] * o[15:18])


CASES = [('sphere24', 256, 1), ('sphere24', 256, 2), ('tiny', 256, 1),
         ('tiny', 256, 2), ('sphere24', 129, 2)]


@pytest.fixture(scope='module', params=CASES,
                ids=['-'.join(map(str, c)) for c in CASES])
def windows(request):
    """JAX and port states after a short and a long window, from the
    same start."""
    name, n, od_slots = request.param
    jgeom, pgeom = request.getfixturevalue(name)
    depth, inst = int(jgeom.mbvh_depth), bool(jgeom.mbvh_instanced)
    W0 = _jax_state(jgeom, n, od_slots, seed=n + od_slots)
    Wp = mbvh_walk.walker_state_from_jax(_np(W0), depth, inst, od_slots)
    out = dict(start=_np(W0), od_slots=od_slots, instanced=inst,
               depth=depth)
    Wj = W0
    for label, iters in (('short', SHORT), ('long', LONG - SHORT)):
        Wj = _run_jax(jgeom, Wj, iters, od_slots)
        _run_port(pgeom, Wp, iters, od_slots)
        out[label] = (_np(Wj),
                      mbvh_walk.walker_state_to_jax(Wp, depth, od_slots))
    return out


@pytest.mark.parametrize('window', ['short', 'long'])
def test_window_matches_pallas(windows, window):
    ref, out = windows[window]
    _assert_close(ref, out, windows['od_slots'], windows['instanced'])


def test_long_window_drains_and_parks(windows):
    """After the long window every walk has drained, and every lane with
    an on-deck ray swapped it in and parked its first walk."""
    start = windows['start']
    ref, out = windows['long']
    assert not (out['uregs'][MP.U_ACT] != 0).any()
    pad = out['uregs'][MP.U_PAD]
    od1 = start['od_uregs'][0] != 0
    walked = start['uregs'][MP.U_ACT] != 0
    assert np.array_equal((pad & 1) != 0, od1 & walked)
    if windows['od_slots'] == 2:
        od2 = start['od2_uregs'][0] != 0
        assert np.array_equal((pad & 4) != 0, od2 & od1 & walked)
        assert ((pad & 4) != 0).any()
    assert ((pad & 1) != 0).any()


def test_lanes_without_on_deck_ray_never_swap(windows):
    start = windows['start']
    _, out = windows['long']
    no_od = start['od_uregs'][0] == 0
    assert no_od.any()
    assert not (out['uregs'][MP.U_PAD][no_od] & 5).any()
    assert np.array_equal(out['rays'][:, no_od], start['rays'][:, no_od])


@pytest.mark.parametrize('name', ['sphere24', 'tiny'])
def test_root_boxes_lohi_matches_jax(request, name):
    jgeom, pgeom = request.getfixturevalue(name)
    ref = np.asarray(MP.root_boxes_lohi(jgeom))[:, 0]
    out = mbvh_walk.root_boxes_lohi(pgeom).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    rbase, rcount, _ = mbvh_walk.root_seed_args(pgeom)
    root = np.asarray(jgeom.mbvh_rows[0])
    assert (rbase, rcount) == (int(root[HDR_BASE]),
                               int(root[HDR_KIND] >> np.uint32(8)))


def test_converter_round_trip_is_exact(tiny):
    """JAX state -> port -> JAX, bit for bit, mid-walk with both on-deck
    slots and parked results present."""
    jgeom, _ = tiny
    W = _np(_run_jax(jgeom, _jax_state(jgeom, 128, 2, seed=5), 40, 2))
    assert (W['uregs'][MP.U_PAD] & 4).any()
    port = mbvh_walk.walker_state_from_jax(W, int(jgeom.mbvh_depth), True, 2)
    assert all(mbvh_walk.in_window_layout(k, v) for k, v in port.items())
    back = mbvh_walk.walker_state_to_jax(port, int(jgeom.mbvh_depth), 2)
    assert sorted(back) == sorted(W)
    for k in W:
        assert back[k].dtype == W[k].dtype, k
        assert np.array_equal(_bits(back[k]), _bits(W[k])), k


@pytest.mark.parametrize('od_slots', [1, 2])
def test_window_split_is_invariant(tiny, od_slots):
    """One window of 60 iterations equals windows of 7, 13 and 40."""
    jgeom, pgeom = tiny
    W0 = _np(_jax_state(jgeom, 192, od_slots, seed=9))
    depth = int(jgeom.mbvh_depth)
    one = mbvh_walk.walker_state_from_jax(W0, depth, True, od_slots)
    split = mbvh_walk.walker_state_from_jax(W0, depth, True, od_slots)
    _run_port(pgeom, one, 60, od_slots)
    for k in (7, 13, 40):
        _run_port(pgeom, split, k, od_slots)
    a = mbvh_walk.walker_state_to_jax(one, depth, od_slots)
    b = mbvh_walk.walker_state_to_jax(split, depth, od_slots)
    for k in a:
        assert np.array_equal(_bits(a[k]), _bits(b[k])), k


def test_cpu_state_takes_the_plain_window(sphere24):
    """walk_window on CPU tensors runs the plain version; the CUDA
    wrapper refuses CPU tensors instead of falling back."""
    jgeom, pgeom = sphere24
    W = mbvh_walk.walker_state_from_jax(
        _np(_jax_state(jgeom, 32, 1, seed=1)), int(jgeom.mbvh_depth), False,
        1)
    before = mbvh_walk.walk_window_launches[1].launches
    _run_port(pgeom, W, 3, 1)
    assert mbvh_walk.walk_window_launches[1].launches == before
    with pytest.raises(ValueError, match='CUDA tensor'):
        mbvh_walk.walk_window_cuda(
            pgeom.mbvh_rows, W, 3, int(pgeom.mbvh_depth), False,
            tmbvh.tquant_scale(pgeom), 1, *mbvh_walk.root_seed_args(pgeom))

"""chroma_tpu_torch closest-hit walk against the JAX Pallas walker.

The port's plain PyTorch walker (the CUDA kernel's reference, which it
runs on CPU tensors) is held against ``intersect_mesh_pallas`` in
interpret mode on the cases of tests/test_mbvh_pallas.py, plus an
axis-parallel ray and an all-miss batch, on identical tables.

Tolerance: triangle ids, material codes and the incomplete flag must be
equal.  Floats cannot be bit-equal: XLA on the CPU contracts a*b+c into
fused multiply-adds (vertex dequantization, dot products, the instance
transform), while the port rounds every product, as its CUDA kernel does
under --fmad=false.  Measured on these cases: distance within 1.1e-6
relative (17 ulp), normal within 5.6e-6 of its length.  The bounds below
leave about 4x of room.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax.numpy as jnp
import torch

from chroma_tpu import make
from chroma_tpu.ops import mbvh_pallas as MP
from chroma_tpu.ops.geometry_pack import pack_geometry
from chroma_tpu_torch import _build
from chroma_tpu_torch.ops import mbvh as tmbvh
from chroma_tpu_torch.ops import mbvh_walk
from tests.test_torch_tables import port_tables

DIST_RTOL = 4e-6
NORMAL_RTOL = 2e-5


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


def _rays(n, seed=0, radius=0.0):
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (rng.uniform(-radius, radius, size=(n, 3)).astype(np.float32)
         if radius else np.zeros((n, 3), np.float32))
    return o, d


def _both(geoms, o, d, lht=None, active=None, max_iters=512):
    jgeom, pgeom = geoms
    jkw, pkw = dict(max_iters=max_iters), dict(max_iters=max_iters)
    if lht is not None:
        jkw['last_hit_triangle'] = jnp.asarray(lht)
        pkw['last_hit_triangle'] = torch.from_numpy(lht.copy())
    if active is not None:
        jkw['active'] = jnp.asarray(active)
        pkw['active'] = torch.from_numpy(active.copy())
    ref = MP.intersect_mesh_pallas(jnp.asarray(o), jnp.asarray(d), jgeom,
                                   block=128, **jkw)
    out = tmbvh.intersect_mesh(torch.from_numpy(o.copy()),
                               torch.from_numpy(d.copy()), pgeom, **pkw)
    return {k: np.asarray(v) for k, v in ref.items()}, \
        {k: v.numpy() for k, v in out.items()}


def _assert_close(ref, out):
    assert np.array_equal(out['triangle'], ref['triangle'])
    assert np.array_equal(out['material_code'].view(np.uint32),
                          ref['material_code'])
    assert np.array_equal(out['incomplete'], ref['incomplete'])
    hit = ref['triangle'] >= 0
    assert np.all(np.isinf(out['distance'][~hit]))
    assert np.all(out['normal'][~hit] == 0)
    rd, od = ref['distance'][hit], out['distance'][hit]
    assert np.all(np.abs(od - rd) <= DIST_RTOL * rd)
    rn, on = ref['normal'][hit], out['normal'][hit]
    length = np.linalg.norm(rn, axis=1)
    assert np.all(np.abs(on - rn).max(axis=1) <= NORMAL_RTOL * length)


def test_walk_matches_pallas_flat(sphere24):
    ref, out = _both(sphere24, *_rays(256))
    assert (out['triangle'] >= 0).all()
    _assert_close(ref, out)


def test_walk_matches_pallas_instanced(tiny):
    ref, out = _both(tiny, *_rays(256, seed=3))
    assert (out['triangle'] >= 0).sum() > 200
    _assert_close(ref, out)


def test_walk_respects_lht_and_active():
    g = _pack_single(make.sphere(50.0, nsteps=16))
    geoms = (g, port_tables(g)[0])
    o, d = _rays(128, seed=5)
    ref0, _ = _both(geoms, o, d)
    lht = ref0['triangle'].astype(np.int32)
    active = np.arange(128) % 2 == 0
    ref, out = _both(geoms, o, d, lht=lht, active=active)
    _assert_close(ref, out)
    assert (out['triangle'][1::2] == -1).all()
    # skipping the first hit from the origin finds nothing closer
    assert not np.any(out['triangle'][::2] == lht[::2])


@pytest.mark.parametrize('n', [341, 85, 129])
def test_walk_ragged_widths(sphere24, n):
    ref, out = _both(sphere24, *_rays(n, seed=7))
    _assert_close(ref, out)


@pytest.mark.parametrize('geom_name', ['sphere24', 'tiny'])
def test_walk_axis_parallel_rays(request, geom_name):
    """1/dir is +-inf on two axes: the slab test's isfinite guards carry
    the walk.  In demo.tiny these walks pass between the PMT boxes for
    about a thousand rows, beyond the Pallas walker's default budget of
    512 iterations, so both walkers get 2048."""
    geoms = request.getfixturevalue(geom_name)
    d = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                  [0, 0, 1], [0, 0, -1]], np.float32)
    # off the centre and off the mesh's symmetry planes, so no ray runs
    # through a vertex or along an edge (a tie the two float paths may
    # break differently)
    o = np.tile(np.array([[0.731, -1.37, 2.113]], np.float32), (6, 1))
    ref, out = _both(geoms, o, d, max_iters=2048)
    assert (out['triangle'] >= 0).all()
    _assert_close(ref, out)


def test_walk_budget_marks_incomplete(tiny):
    """A walk cut by max_iters reports incomplete and no hit, in both."""
    d = np.array([[1, 0, 0]], np.float32)
    o = np.array([[0.731, -1.37, 2.113]], np.float32)
    ref, out = _both(tiny, o, d, max_iters=64)
    assert out['incomplete'].all()
    _assert_close(ref, out)


def test_walk_all_miss(sphere24):
    """Rays that start outside the sphere and point away hit nothing."""
    o, d = _rays(64, seed=11)
    o = (d * 80.0).astype(np.float32)
    ref, out = _both(sphere24, o, d)
    assert (out['triangle'] == -1).all()
    _assert_close(ref, out)


def test_cpu_tensors_take_the_plain_walker(sphere24):
    """intersect_mesh on CPU tensors runs the plain version; the CUDA
    wrapper refuses CPU tensors instead of falling back."""
    _, pgeom = sphere24
    o, d = _rays(16)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    before = mbvh_walk.closest_hit_launches.launches
    tmbvh.intersect_mesh(o, d, pgeom)
    assert mbvh_walk.closest_hit_launches.launches == before
    with pytest.raises(ValueError, match='CUDA tensor'):
        mbvh_walk.closest_hit_cuda(
            pgeom.mbvh_rows, o, d, torch.full((16,), -1, dtype=torch.int32),
            torch.ones(16, dtype=torch.bool), tmbvh.tquant_scale(pgeom),
            pgeom.mbvh_depth, pgeom.mbvh_instanced, 100)


@pytest.mark.parametrize('depth,ok', [
    (0, False), (1, True), (2, True), (4, True), (6, True), (7, True),
    (11, True), (12, True), (13, False)])
def test_kernels_hold_every_depth_up_to_max_levels(depth, ok):
    """One kernel build holds MAX_SLOTS = 11 pending levels, so every
    tree of depth 1..12 (MAX_LEVELS) launches it; the wrappers refuse
    any other depth before building anything."""
    assert mbvh_walk.KERNEL_MAX_DEPTH == tmbvh.MAX_LEVELS
    if ok:
        mbvh_walk.check_kernel_layout(depth)
        return
    with pytest.raises(ValueError, match='depth'):
        mbvh_walk.check_kernel_layout(depth)
    rows = torch.zeros((1, mbvh_walk.ROW_WIDTH), dtype=torch.int32)
    with pytest.raises(ValueError, match='depth'):
        mbvh_walk.closest_hit_cuda(
            rows, torch.zeros((1, 3)), torch.ones((1, 3)),
            torch.full((1,), -1, dtype=torch.int32),
            torch.ones(1, dtype=torch.bool), 1.0, depth, False, 10)
    with pytest.raises(ValueError, match='depth'):
        mbvh_walk.walk_window_cuda(rows, {}, 17, depth, False, 1.0, 1, 0, 0,
                                   torch.zeros(6 * mbvh_walk.BRANCH))


def test_nvcc_flags_keep_ieee_floats():
    """The kernel must build for Hopper with separate multiply and add
    roundings (bit-equal to the plain version) and never with fast math,
    which flushes subnormals and approximates 1/x."""
    flags = ' '.join(_build.NVCC_FLAGS)
    assert 'sm_90a' in flags
    assert '--fmad=false' in _build.NVCC_FLAGS
    assert '--use_fast_math' not in flags
    assert _build.sources() == [
        _build.os.path.join(_build.CSRC_DIR, name)
        for name in ('mbvh_walk.cu', 'mbvh_walk_window.cu')]

"""Hand-written CUDA kernels of chroma_tpu_torch against their plain
PyTorch versions, on the card.

These tests need an NVIDIA card and nvcc, and skip elsewhere.  They
import neither jax nor tests/conftest.py (which does), so on a card host
without JAX they run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Kernel and plain version must agree bit for bit: the kernel is built
with --fmad=false, so both round every product.
"""
import numpy as np
import pytest
import torch

from chroma_tpu_torch import host
from chroma_tpu_torch.ops import mbvh as tmbvh
from chroma_tpu_torch.ops import mbvh_walk
from chroma_tpu_torch.ops.geometry_pack import pack_geometry


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: CUDA kernels have no CPU build')
    return torch.device('cuda')


def _rays(n, seed, dev):
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.zeros((n, 3), device=dev), torch.from_numpy(d).to(dev))


def _assert_bit_equal(tables, o, d, lht=None, active=None):
    n = o.shape[0]
    lht = torch.full((n,), -1, dtype=torch.int32, device=o.device) \
        if lht is None else lht
    active = torch.ones(n, dtype=torch.bool, device=o.device) \
        if active is None else active
    args = (tables.mbvh_rows, o, d, lht, active, tmbvh.tquant_scale(tables),
            tables.mbvh_depth, tables.mbvh_instanced, 65536)
    before = mbvh_walk.closest_hit_launches.launches
    k = mbvh_walk.closest_hit_cuda(*args)
    torch.cuda.synchronize()
    assert mbvh_walk.closest_hit_launches.launches == before + 1
    p = mbvh_walk.closest_hit_plain(*args)
    for key in ('triangle', 'material_code', 'incomplete'):
        assert torch.equal(k[key], p[key]), key
    for key in ('distance', 'normal'):
        assert torch.equal(k[key].view(torch.int32),
                           p[key].view(torch.int32)), key
    return k


@pytest.mark.cuda
@pytest.mark.parametrize('n', [256, 341, 85, 129])
def test_walk_kernel_flat_sphere(dev, n):
    g = pack_geometry(host.mesh_geometry(host.make.sphere(50.0, nsteps=24)),
                      dev)
    k = _assert_bit_equal(g, *_rays(n, n, dev))
    assert (k['triangle'] >= 0).all()


@pytest.mark.cuda
def test_walk_kernel_lht_and_active(dev):
    g = pack_geometry(host.mesh_geometry(host.make.sphere(50.0, nsteps=16)),
                      dev)
    o, d = _rays(128, 5, dev)
    first = _assert_bit_equal(g, o, d)['triangle']
    active = torch.arange(128, device=dev) % 2 == 0
    k = _assert_bit_equal(g, o, d, lht=first, active=active)
    assert (k['triangle'][1::2] == -1).all()


@pytest.mark.cuda
def test_walk_kernel_instanced_tiny(dev):
    tiny = host.demo.tiny()
    tiny.flatten()
    g = pack_geometry(tiny, dev)
    assert g.mbvh_instanced
    k = _assert_bit_equal(g, *_rays(4096, 3, dev))
    assert (k['triangle'] >= 0).float().mean() > 0.9
    # axis-parallel rays: 1/dir = +-inf on two axes
    d = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], dtype=torch.float32,
                     device=dev)
    o = torch.tensor([[0.731, -1.37, 2.113]], device=dev).expand(6, 3)
    _assert_bit_equal(g, o.contiguous(), d)


def _tables(name, dev):
    if name == 'sphere24':
        return pack_geometry(host.mesh_geometry(
            host.make.sphere(50.0, nsteps=24)), dev)
    if name == 'ties':
        return pack_geometry(host.tie_geometry(), dev)
    if name == 'ties_instanced':
        return pack_geometry(host.tie_geometry(), dev, instancing=True)
    tiny = host.demo.tiny()
    tiny.flatten()
    return pack_geometry(tiny, dev)


# ray counts at the edges of a warp (one warp walks one ray) and of a
# block (8 rays): 1001 is not a multiple of the block
GROUP_EDGES = [1, 31, 33, 129, 1001]


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['sphere24', 'tiny'])
@pytest.mark.parametrize('n', GROUP_EDGES)
def test_walk_kernel_group_edges(dev, name, n):
    """Ragged ray counts through K1 (flat sphere) and K2 (demo.tiny)."""
    g = _tables(name, dev)
    _assert_bit_equal(g, *_rays(n, 100 + n, dev))


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['ties', 'ties_instanced', 'tiny'])
@pytest.mark.parametrize('od_slots', [1, 2])
def test_window_kernel_axis_rays(dev, name, od_slots):
    """Six lanes walking along the axes (1/dir infinite on two axes),
    restarting on axis-parallel on-deck rays: bit-equal to plain."""
    g = _tables(name, dev)
    depth, inst = int(g.mbvh_depth), bool(g.mbvh_instanced)
    o, d = (torch.from_numpy(a).to(dev) for a in host.axis_rays())
    every = torch.ones(6, dtype=torch.bool, device=dev)
    k = mbvh_walk.window_state(
        g.mbvh_rows, depth, inst, tmbvh.tquant_scale(g), o, d, every,
        [(o, -d, every), (o, d.roll(2, 0), every)][:od_slots])
    p = _clone_state(k)
    seed_args = mbvh_walk.root_seed_args(g)
    for iters in (17, 3000):
        tmbvh.walk_window(g, k, iters, od_slots, *seed_args)
        torch.cuda.synchronize()
        tmbvh.walk_window(g, p, iters, od_slots, *seed_args, plain=True)
        for key in k:
            a, b = k[key], p[key]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (iters, key)
    assert (k['pad'] & 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['ties', 'ties_instanced'])
def test_walk_kernel_ties(dev, name):
    """Twin triangles at equal distances and (instanced) two entries with
    equal boxes, random and axis-parallel rays, and the last-hit skip of
    a twin: the lowest-slot rule decides every tie, as in the plain
    version."""
    g = _tables(name, dev)
    assert g.mbvh_instanced == (name == 'ties_instanced')
    o, d = _rays(300, 8, dev)
    first = _assert_bit_equal(g, o, d)['triangle']
    assert (first >= 0).all()
    _assert_bit_equal(g, o, d, lht=first)
    ao, ad = host.axis_rays()
    _assert_bit_equal(g, torch.from_numpy(ao).to(dev),
                      torch.from_numpy(ad).to(dev))


@pytest.mark.cuda
def test_intersect_mesh_dispatches_to_kernel(dev):
    g = pack_geometry(host.mesh_geometry(host.make.sphere(50.0, nsteps=24)),
                      dev)
    o, d = _rays(64, 1, dev)
    before = mbvh_walk.closest_hit_launches.launches
    tmbvh.intersect_mesh(o, d, g)
    assert mbvh_walk.closest_hit_launches.launches == before + 1


# ---- the on-deck window kernel (K3, K4) and the driver around it ------

def _clone_state(W):
    return mbvh_walk.window_layout({k: v.clone() for k, v in W.items()})


@pytest.mark.cuda
@pytest.mark.parametrize('name,n,od_slots', [
    ('sphere24', 256, 1), ('sphere24', 256, 2), ('tiny', 256, 1),
    ('tiny', 256, 2), ('sphere24', 129, 2), ('tiny', 129, 1),
    ('ties', 256, 1), ('ties_instanced', 256, 2)]
    + [(name, n, od_slots) for name in ('sphere24', 'tiny')
       for n in (1, 31, 33, 1001) for od_slots in (1, 2)])
def test_window_kernel_matches_plain(dev, name, n, od_slots):
    """A service window of 17 iterations, then a long window in which
    every walk drains: every state field bit-equal after each (ragged
    lane counts at the warp and block edges, and the tie scenes)."""
    g = _tables(name, dev)
    depth, inst = int(g.mbvh_depth), bool(g.mbvh_instanced)
    sq = tmbvh.tquant_scale(g)
    seed_args = mbvh_walk.root_seed_args(g)
    k = mbvh_walk.random_window_state(g.mbvh_rows, depth, inst, sq, n,
                                      od_slots, n + od_slots)
    p = _clone_state(k)
    counter = mbvh_walk.walk_window_launches[od_slots]
    for iters in (17, 3000):
        before = counter.launches
        tmbvh.walk_window(g, k, iters, od_slots, *seed_args)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        tmbvh.walk_window(g, p, iters, od_slots, *seed_args, plain=True)
        for key in k:
            a, b = k[key], p[key]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (iters, key)
    assert not k['act'].any() and (k['lvl'] < 0).all()
    assert n < 32 or ((k['pad'] & 1) != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize('od_slots', [1, 2])
def test_ondeck_driver_kernel_matches_plain(dev, od_slots):
    """The whole on-deck driver on demo.tiny, window kernel against its
    plain version, same generator seed: the final photons bit-equal."""
    from chroma_tpu_torch import gpu
    from chroma_tpu_torch.ops import fused
    g = _tables('tiny', dev)
    np.random.seed(4)
    ph = host.photon_bomb(8192, 400.0, (200.0, 0.0, 0.0)).photons_beg
    outs = []
    for plain in (False, True):
        state = gpu.GPUPhotons(ph, dev).state
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        outs.append(fused.propagate_fused(
            state, g, fused.uniform_draws(gen), max_steps=40, width=2048,
            service_every=17, od_slots=od_slots, plain_walker=plain))
    (k, ks), (p, ps) = outs
    assert torch.equal(ks, ps)
    for key in k:
        a, b = k[key], p[key]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), key


@pytest.mark.cuda
def test_referee_terminal_passthrough_on_card(dev):
    from chroma_tpu_torch import referee
    g = _tables('tiny', dev)
    for od_slots in (1, 2):
        assert referee.terminal_passthrough(g, od_slots=od_slots) == []

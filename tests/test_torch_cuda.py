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


@pytest.mark.cuda
def test_intersect_mesh_dispatches_to_kernel(dev):
    g = pack_geometry(host.mesh_geometry(host.make.sphere(50.0, nsteps=24)),
                      dev)
    o, d = _rays(64, 1, dev)
    before = mbvh_walk.closest_hit_launches.launches
    tmbvh.intersect_mesh(o, d, g)
    assert mbvh_walk.closest_hit_launches.launches == before + 1

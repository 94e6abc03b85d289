"""The escape-rope walker of chroma_tpu_torch against the JAX package's.

* ``compute_escape_pointers``, the ``nodes`` / ``escape`` /
  ``tri_vertices`` tables and ``interp_property``: bit-equal to the JAX
  package's;
* ``intersect_triangle`` and ``intersect_box`` on 20,000 random cases:
  hit flags equal; a hit's distance within 64 ulp of the JAX
  function's and a box's within 4 ulp (XLA on the CPU contracts a*b+c
  into fused multiply-adds, PyTorch rounds each product, and the
  triangle test's cross products cancel: 56 ulp is the worst hit here);
* ``ops/mesh.intersect_mesh`` on tests/test_intersect.py's meshes: the
  triangle ids equal to the JAX escape-rope walker's and to brute force
  over all triangles (with the port's own ``intersect_triangle``), the
  distances within 1e-5 relative of the JAX walker's; ``chunked`` and
  ``distance_to_mesh`` give the same answers in waves;
* the shared table cache: an entry with the legacy tables written by the
  JAX package loads equal, an entry without them loads with the
  placeholders, and loading writes nothing.
"""
import os

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax.numpy as jnp
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import make as jmake
from chroma_tpu.geometry import Geometry as JGeometry, Solid as JSolid
from chroma_tpu.geometry import vacuum as jvacuum
from chroma_tpu.loader import create_geometry_from_obj as jcreate
from chroma_tpu.ops import geometry_pack as jgp
from chroma_tpu.ops import intersect as jint
from chroma_tpu.ops import mesh as jmesh
from chroma_tpu.ops import table_cache as jtc
from chroma_tpu_torch import make
from chroma_tpu_torch.geometry import Geometry, Solid, vacuum
from chroma_tpu_torch.loader import create_geometry_from_obj
from chroma_tpu_torch.ops import geometry_pack as tgp
from chroma_tpu_torch.ops import intersect as tint
from chroma_tpu_torch.ops import mesh as tmesh
from chroma_tpu_torch.ops import table_cache as ttc
from tests.test_intersect import brute_force as jax_brute_force, random_rays

TRI_ULP, BOX_ULP = 64, 4
DIST_RTOL = 1e-5
LEGACY = ('nodes', 'escape', 'tri_vertices')
MESHES = {
    'cube': (jmake.cube, make.cube, (2.0,), {}),
    'sphere': (jmake.sphere, make.sphere, (1.5,), dict(nsteps=24)),
    'torus': (jmake.torus, make.torus, (0.5, 1.5), dict(nsteps=16)),
}


def _pair(name):
    jfn, tfn, args, kw = MESHES[name]
    jgeo = jcreate(jfn(*args, **kw), update_bvh_cache=False)
    tgeo = create_geometry_from_obj(tfn(*args, **kw), update_bvh_cache=False)
    return jgp.pack_geometry(jgeo), tgp.pack_geometry(tgeo, 'cpu'), tgeo.mesh


@pytest.fixture(scope='module', params=sorted(MESHES))
def packs(request):
    return _pair(request.param)


def _np(t, name=''):
    a = t.numpy()
    return a.view(np.uint32) if name in tgp.U32_FIELDS else a


def _ulps(a, b):
    """|a - b| in units in the last place of float32, per element."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def test_legacy_tables_match_jax(packs):
    jgeom, pgeom, _ = packs
    for name in LEGACY + ('legacy_world_origin', 'legacy_world_scale'):
        want = np.asarray(getattr(jgeom, name))
        got = _np(getattr(pgeom, name), name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert np.array_equal(got, want), name
    assert pgeom.nodes.shape[0] > 1


def test_escape_pointers_match_jax(packs):
    jgeom, _, _ = packs
    nodes = np.asarray(jgeom.nodes)
    want = jgp.compute_escape_pointers(nodes)
    got = tgp.compute_escape_pointers(nodes)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    # the root's rope ends the walk; every other pointer lands in range
    assert got[0] == tgp.ESCAPE_SENTINEL
    inner = got[got != tgp.ESCAPE_SENTINEL]
    assert (inner < len(nodes)).all()


def test_placeholders_without_a_bvh():
    """A mesh with no BVH, or a forced ``include_legacy_bvh=False``,
    packs the one-row placeholders, as the JAX package does."""
    jgeo = JGeometry(jvacuum)
    jgeo.add_solid(JSolid(jmake.cube(1.0), jvacuum, jvacuum))
    jgeo.flatten()
    geo = Geometry(vacuum)
    geo.add_solid(Solid(make.cube(1.0), vacuum, vacuum))
    geo.flatten()
    jgeom, pgeom = jgp.pack_geometry(jgeo), tgp.pack_geometry(geo, 'cpu')
    for name in LEGACY:
        assert np.array_equal(_np(getattr(pgeom, name), name),
                              np.asarray(getattr(jgeom, name))), name
        assert getattr(pgeom, name).shape[0] == 1
    tgeo = create_geometry_from_obj(make.cube(1.0), update_bvh_cache=False)
    off = tgp.pack_geometry(tgeo, 'cpu', include_legacy_bvh=False)
    assert off.nodes.shape == (1, 4) and off.tri_vertices.shape == (1, 3, 3)


def test_interp_property_matches_jax(packs):
    jgeom, pgeom, _ = packs
    rng = np.random.RandomState(3)
    n = 4000
    wl = rng.uniform(100.0, 1000.0, n).astype(np.float32)
    wl[:4] = [60.0, 995.0, 2000.0, 10.0]       # the grid's ends, clamped
    mat = rng.randint(0, jgeom.refractive_index.shape[0], n).astype(np.int32)
    for table in ('refractive_index', 'absorption_length',
                  'scattering_length'):
        want = np.asarray(jgp.interp_property(
            jgeom, getattr(jgeom, table), jnp.asarray(mat), jnp.asarray(wl)))
        got = tgp.interp_property(pgeom, getattr(pgeom, table),
                                  torch.from_numpy(mat).long(),
                                  torch.from_numpy(wl)).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), table


def test_intersect_triangle_and_box_match_jax():
    rng = np.random.RandomState(5)
    n = 20000
    o, d = random_rays(n, seed=6)
    v = rng.uniform(-2, 2, (3, n, 3)).astype(np.float32)
    jh, jt = jint.intersect_triangle(*map(jnp.asarray, (o, d, *v)))
    th, tt = tint.intersect_triangle(*map(torch.from_numpy, (o, d, *v)))
    jh, jt, th, tt = np.asarray(jh), np.asarray(jt), th.numpy(), tt.numpy()
    assert np.array_equal(jh, th)
    assert jh.sum() > 300
    assert np.all(_ulps(jt[jh], tt[jh]) <= TRI_ULP)

    lo = rng.uniform(-2, 0, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 2, (n, 3)).astype(np.float32)
    d[:50, 0] = 0.0                                  # 1/dir infinite
    with np.errstate(divide='ignore'):
        inv = (1.0 / d).astype(np.float32)
    noid = (-o * inv).astype(np.float32)
    jb, jd = jint.intersect_box(*map(jnp.asarray, (noid, inv, lo, hi)))
    tb, td = tint.intersect_box(*map(torch.from_numpy, (noid, inv, lo, hi)))
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert np.all(_ulps(np.asarray(jd), td.numpy()) <= BOX_ULP)
    assert tb.numpy().sum() > 300 and not tb.numpy().all()


def test_walker_matches_jax_and_brute_force(packs):
    jgeom, pgeom, mesh = packs
    o, d = random_rays(500)
    jtri, jdist = jmesh.intersect_mesh(jnp.asarray(o), jnp.asarray(d), jgeom)
    tri, dist = tmesh.intersect_mesh(torch.from_numpy(o), torch.from_numpy(d),
                                     pgeom)
    jtri, jdist, tri, dist = (np.asarray(jtri), np.asarray(jdist),
                              tri.numpy(), dist.numpy())
    assert np.array_equal(tri, jtri)
    hit = tri >= 0
    assert hit.sum() >= 50
    np.testing.assert_allclose(dist[hit], jdist[hit], rtol=DIST_RTOL, atol=0)
    assert np.isinf(dist[~hit]).all()
    # brute force over all triangles with the port's own test
    tv = torch.from_numpy(np.asarray(mesh.vertices[mesh.triangles],
                                     np.float32))
    h, t = tint.intersect_triangle(
        torch.from_numpy(o)[:, None], torch.from_numpy(d)[:, None],
        tv[None, :, 0], tv[None, :, 1], tv[None, :, 2])
    t = torch.where(h, t, torch.inf)
    best = t.argmin(dim=1)
    bdist = t[torch.arange(len(o)), best]
    btri = torch.where(torch.isfinite(bdist), best, -1).numpy()
    assert np.array_equal(tri, btri)
    assert np.array_equal(dist[hit], bdist.numpy()[hit])
    # and the JAX brute force classifies hits the same way
    assert np.array_equal(jax_brute_force(o, d, mesh)[0] >= 0, hit)


def test_last_hit_skip_and_waves():
    _, pgeom, _ = _pair('sphere')
    o, d = random_rays(300, seed=9)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    tri, dist = tmesh.intersect_mesh(o, d, pgeom)
    tri2, _ = tmesh.intersect_mesh(o, d, pgeom, last_hit_triangle=tri)
    hit = tri >= 0
    assert not (tri2[hit] == tri[hit]).any()
    # distance_to_mesh normalizes and may cut the batch into waves
    tri3, dist3 = tmesh.intersect_mesh(o, tint.normalize(d * 3.0), pgeom)
    assert torch.equal(tri3, tri)
    for wave in (64, 1000):
        wt, wd = tmesh.distance_to_mesh(o, d * 3.0, pgeom, wave=wave)
        assert torch.equal(wt, tri3) and torch.equal(wd, dist3)
    jt, jd = jmesh.distance_to_mesh(jnp.asarray(o.numpy()),
                                    jnp.asarray(d.numpy() * 3.0),
                                    jgp.pack_geometry(jcreate(
                                        jmake.sphere(1.5, nsteps=24),
                                        update_bvh_cache=False)), wave=64)
    assert np.array_equal(np.asarray(jt), tri.numpy())


def test_multi_solid_scene():
    geo = Geometry(vacuum)
    geo.add_solid(Solid(make.cube(1.0), vacuum, vacuum))
    geo.add_solid(Solid(make.cube(1.0), vacuum, vacuum),
                  displacement=(5.0, 0, 0))
    geo.flatten()
    geo = create_geometry_from_obj(geo, update_bvh_cache=False)
    pgeom = tgp.pack_geometry(geo, 'cpu')
    o = torch.tensor([[-3.0, 0.0, 0.0], [2.5, 0.0, 0.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    tri, dist = tmesh.intersect_mesh(o, d, pgeom)
    np.testing.assert_allclose(dist.numpy(), [2.5, 2.0], atol=1e-5)
    assert int(geo.solid_id[int(tri[1])]) == 1


def test_table_cache_legacy_fields(packs, tmp_path, monkeypatch):
    jgeom, pgeom, _ = packs
    monkeypatch.setenv('CHROMA_TPU_CACHE', str(tmp_path))
    jtc.save_tables('walker', jgeom)
    d = os.path.join(str(tmp_path), 'tables', 'walker')
    before = {f: os.stat(os.path.join(d, f)).st_mtime_ns
              for f in os.listdir(d)}
    geom, _ = ttc.load_tables('walker', 'cpu')
    for name in LEGACY:
        assert np.array_equal(_np(getattr(geom, name), name),
                              np.asarray(getattr(jgeom, name))), name
    assert before == {f: os.stat(os.path.join(d, f)).st_mtime_ns
                      for f in os.listdir(d)}
    # the port's own entry loads in the JAX package with its tables
    ttc.save_tables('port', pgeom)
    jgeom2, _ = jtc.load_tables('port')
    for name in LEGACY:
        assert np.array_equal(np.asarray(getattr(jgeom2, name)),
                              np.asarray(getattr(jgeom, name))), name
    # an entry without the legacy files loads with the placeholders
    for name in LEGACY:
        os.remove(os.path.join(d, 'geom_%s.npy' % name))
    geom, _ = ttc.load_tables('walker', 'cpu')
    for name in LEGACY:
        assert np.array_equal(_np(getattr(geom, name), name),
                              tgp.LEGACY_PLACEHOLDERS[name]), name
    assert not any(f.startswith('geom_nodes') for f in os.listdir(d))

"""The port's own host layer against the JAX package's.

chroma_tpu_torch keeps copies of the numpy host modules it needs (event,
geometry, detector, make, demo, loader, cache, bvh, generator.photon,
native) instead of importing chroma_tpu.  Each package here builds its
own scenes and photons; what the port builds must equal what the JAX
package builds, bit for bit: the packed tables field by field, the
photon bombs array by array, the row-layout constants.
"""
import os

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax  # noqa: F401  (imported before torch, as the test files do)
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import demo as jdemo, make as jmake
from chroma_tpu.bvh import mbvh as jmbvh
from chroma_tpu.generator.photon import photon_bomb as jphoton_bomb
from chroma_tpu.geometry import Geometry as JGeometry, Solid as JSolid, \
    vacuum as jvacuum
from chroma_tpu.ops import geometry_pack as jgp
from chroma_tpu_torch import host, native
from chroma_tpu_torch.bvh import mbvh as tmbvh
from chroma_tpu_torch.ops import geometry_pack as tgp
from tests.test_torch_tables import _assert_equal_tables


def _jax_sphere():
    geo = JGeometry(jvacuum)
    geo.add_solid(JSolid(jmake.sphere(50.0, nsteps=24), jvacuum, jvacuum))
    geo.flatten()
    return geo


def _jax_ties():
    mesh = jmake.sphere(50.0, nsteps=16)
    geo = JGeometry(jvacuum)
    for _ in range(2):
        geo.add_solid(JSolid(mesh, jvacuum, jvacuum))
    geo.flatten()
    return geo


@pytest.fixture(scope='module')
def tiny_packs():
    jdet = jdemo.tiny()
    jdet.flatten()
    pdet = host.demo.tiny()
    pdet.flatten()
    assert type(pdet).__module__.startswith('chroma_tpu_torch.')
    return jgp.pack_detector(jdet), tgp.pack_detector(pdet, 'cpu')


@pytest.mark.parametrize('which', ['geom', 'det'])
def test_own_demo_tiny_packs_like_jax(tiny_packs, which):
    """Each package builds demo.tiny() with its own modules (and its own
    native BVH builder); the packed tables are bit-equal."""
    (jgeom, jdet), (pgeom, pdet) = tiny_packs
    if which == 'geom':
        assert pgeom.mbvh_instanced
        _assert_equal_tables(jgeom, pgeom)
    else:
        _assert_equal_tables(jdet, pdet)


@pytest.mark.parametrize('scene,instancing', [
    ('sphere', None), ('ties', None), ('ties', True)])
def test_own_scenes_pack_like_jax(scene, instancing):
    """The flat sphere and the tie scene (host.tie_geometry, flat and
    instanced), built by each package: bit-equal tables."""
    if scene == 'sphere':
        jgeo = _jax_sphere()
        pgeo = host.mesh_geometry(host.make.sphere(50.0, nsteps=24))
    else:
        jgeo = _jax_ties()
        pgeo = host.tie_geometry()
    jt = jgp.pack_geometry(jgeo, instancing=instancing)
    pt = tgp.pack_geometry(pgeo, 'cpu', instancing=instancing)
    assert pt.mbvh_instanced == bool(instancing)
    _assert_equal_tables(jt, pt)


def test_photon_bomb_matches_jax():
    """The same numpy seed gives the same photons in both packages."""
    np.random.seed(17)
    j = jphoton_bomb(1000, 420.0, (10.0, -20.0, 30.0), t0=1.5).photons_beg
    np.random.seed(17)
    p = host.photon_bomb(1000, 420.0, (10.0, -20.0, 30.0),
                         t0=1.5).photons_beg
    assert type(p).__module__ == 'chroma_tpu_torch.event'
    for f in ('pos', 'dir', 'pol', 'wavelengths', 't', 'last_hit_triangles',
              'flags', 'weights', 'evidx', 'channel'):
        a, b = getattr(j, f), getattr(p, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize('name', [
    'BRANCH', 'ROW_WIDTH', 'LAYOUT_VERSION', 'TARGET_DEGREE', 'HDR_KIND',
    'HDR_BASE', 'BOX_OFF', 'QORIGIN_OFF', 'QSCALE_OFF', 'QVERT_OFF',
    'QVERT_WORDS_PER_COMP', 'TRI_ID_OFF', 'MAT_OFF', 'IBOX_ORIGIN_OFF',
    'IBOX_SCALE_OFF', 'XFORM_OFF', 'TRI_BASE_OFF', 'KIND_CLUSTER',
    'KIND_LOCAL', 'KIND_ENTRY', 'USE_SAH'])
def test_row_layout_constants_match_jax(name):
    assert getattr(tmbvh, name) == getattr(jmbvh, name)


def test_builder_tag_matches_jax():
    """Both packages name their tree builder alike, so the packed-table
    cache written by one is accepted by the other."""
    assert tmbvh.builder_tag() == jmbvh.builder_tag()


def test_native_builds_to_a_temporary_name_and_loads(tmp_path, monkeypatch):
    """The native library is compiled under a temporary name in the
    build directory and renamed into place; it then loads and sorts."""
    import ctypes
    renames = []
    real_replace = os.replace

    def spy(src, dst):
        renames.append((src, dst))
        return real_replace(src, dst)

    monkeypatch.setattr(native.os, 'replace', spy)
    out = native.build(str(tmp_path))
    assert out == native.library_path(str(tmp_path))
    assert [dst for _, dst in renames] == [out]
    src = renames[0][0]
    assert os.path.dirname(src) == str(tmp_path) and src != out
    assert os.listdir(str(tmp_path)) == [os.path.basename(out)]
    # a second build finds it and compiles nothing
    assert native.build(str(tmp_path)) == out and len(renames) == 1
    lib = ctypes.CDLL(out)
    keys = np.array([5, 1, 4, 1, 3], np.uint64)
    order = np.empty(5, np.int64)
    lib.radix_sort_u64(keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                       ctypes.c_int64(5),
                       order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    assert order.tolist() == [1, 3, 4, 2, 0]


def test_native_lives_in_the_port():
    assert native.SOURCE.endswith(
        os.path.join('chroma_tpu_torch', 'csrc', 'host_native.cc'))
    assert native.native() is not None
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR


def test_port_cache_keeps_its_pickles_apart(tmp_path):
    """The port pickles its own classes, in directories of its own."""
    from chroma_tpu_torch.cache import Cache
    c = Cache(str(tmp_path))
    assert os.path.basename(c.bvh_dir) == 'torch_bvh'
    assert os.path.basename(c.geo_dir) == 'torch_geo'
    mb = tmbvh.build_mbvh(host.make.sphere(10.0, nsteps=8))
    c.save_bvh(mb, 'h', 'n')
    back = c.load_bvh('h', 'n')
    assert type(back) is tmbvh.MBVH and np.array_equal(back.rows, mb.rows)
    assert os.listdir(c.get_bvh_directory('h')) == ['n']

"""chroma_tpu_torch tables against the JAX package's packing.

The port packs with numpy (sharing the MBVH builder and BVH cache) and
uploads to torch; every array field and static field must equal the
JAX package's pack of the same detector, bit for bit.  The packed-table
cache format is shared: a cache either package writes loads in both.
"""
import dataclasses

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax  # noqa: F401  (imported before torch, as the test files do)
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import demo
from chroma_tpu.ops import geometry_pack as jgp
from chroma_tpu.ops import table_cache as jtc
from chroma_tpu_torch.ops import geometry_pack as tgp
from chroma_tpu_torch.ops import table_cache as ttc


def jax_fields(tables):
    """(numpy arrays, static fields) of a JAX-package tables object."""
    arrays, static = {}, {}
    for f in dataclasses.fields(tables):
        v = getattr(tables, f.name)
        if f.metadata.get('pytree_node', True):
            arrays[f.name] = np.asarray(v)
        else:
            static[f.name] = v
    return arrays, static


def port_tables(jgeom, jdet=None, device='cpu'):
    """The port's tables holding exactly the JAX package's arrays."""
    g_arrays, g_static = jax_fields(jgeom)
    static = {'geom': g_static}
    d_arrays = None
    if jdet is not None:
        d_arrays, static['det'] = jax_fields(jdet)
    return tgp.tables_from_numpy(g_arrays, d_arrays, static, device)


def _as_numpy(t, name):
    a = t.numpy()
    return a.view(np.uint32) if name in tgp.U32_FIELDS else a


@pytest.fixture(scope='module')
def tiny_detector():
    det = demo.tiny()
    det.flatten()
    return det


@pytest.fixture(scope='module')
def both_packs(tiny_detector):
    return (jgp.pack_detector(tiny_detector),
            tgp.pack_detector(tiny_detector, 'cpu'))


def _assert_equal_tables(jax_tables, port):
    arrays, static = jax_fields(jax_tables)
    cls = type(port)
    for name in tgp.array_fields(cls):
        got = _as_numpy(getattr(port, name), name)
        want = arrays[name]
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert np.array_equal(got, want, equal_nan=True), name
    for name in tgp.static_fields(cls):
        assert getattr(port, name) == static[name], name
    # the port carries every JAX field, the escape-rope walker's
    # ``nodes``, ``escape`` and ``tri_vertices`` among them
    assert set(arrays) == set(tgp.array_fields(cls))
    assert set(static) == set(tgp.static_fields(cls))


@pytest.mark.parametrize('which', ['geom', 'det'])
def test_pack_detector_matches_jax(both_packs, which):
    (jgeom, jdet), (pgeom, pdet) = both_packs
    if which == 'geom':
        assert pgeom.mbvh_instanced and pgeom.has_surfaces
        _assert_equal_tables(jgeom, pgeom)
    else:
        _assert_equal_tables(jdet, pdet)


def test_tables_from_numpy_round_trip(both_packs):
    (jgeom, jdet), _ = both_packs
    pgeom, pdet = port_tables(jgeom, jdet)
    _assert_equal_tables(jgeom, pgeom)
    _assert_equal_tables(jdet, pdet)
    moved = pgeom.to('cpu')
    assert moved.mbvh_rows.device.type == 'cpu'
    assert torch.equal(moved.mbvh_rows, pgeom.mbvh_rows)


def test_jax_table_cache_loads_in_port(both_packs, tmp_path, monkeypatch):
    (jgeom, jdet), (pgeom, pdet) = both_packs
    monkeypatch.setenv('CHROMA_TPU_CACHE', str(tmp_path))
    jtc.save_tables('tiny', jgeom, jdet)
    hit = ttc.load_tables('tiny', 'cpu')
    assert hit is not None
    _assert_equal_tables(jgeom, hit[0])
    _assert_equal_tables(jdet, hit[1])
    assert ttc.load_tables('absent', 'cpu') is None


def test_port_table_cache_loads_in_jax(both_packs, tmp_path, monkeypatch):
    (jgeom, jdet), (pgeom, pdet) = both_packs
    monkeypatch.setenv('CHROMA_TPU_CACHE', str(tmp_path))
    ttc.save_tables('tiny', pgeom, pdet)
    hit = jtc.load_tables('tiny')
    assert hit is not None
    _assert_equal_tables(hit[0], pgeom)
    _assert_equal_tables(hit[1], pdet)


def test_stale_table_cache_is_refused(both_packs, tmp_path, monkeypatch):
    import json
    import os
    _, (pgeom, pdet) = both_packs
    monkeypatch.setenv('CHROMA_TPU_CACHE', str(tmp_path))
    ttc.save_tables('tiny', pgeom, pdet)
    meta_path = os.path.join(str(tmp_path), 'tables', 'tiny', 'meta.json')
    with open(meta_path) as f:
        meta = json.load(f)
    meta['mbvh_layout'] = -1
    with open(meta_path, 'w') as f:
        json.dump(meta, f)
    assert ttc.load_tables('tiny', 'cpu') is None

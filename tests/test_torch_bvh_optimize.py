"""The port's BVH tools (chroma_tpu_torch/bvh: optimize.py, the node
areas and layer methods of bvh.py, merge_nodes and make_simple_bvh of
build.py) against the JAX package's, in the shapes of tests/test_bvh.py.

All of it is host numpy over the packed (N, 4) uint32 node array; from
the same mesh both packages must build and reorder the same nodes
(tolerance: none; nodes, permutations and layer offsets bit-equal,
areas equal as floats).
"""
import inspect

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax  # noqa: F401  (imported before torch, as the test files do)
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import bvh as jbvh
from chroma_tpu import make as jmake
from chroma_tpu.bvh import optimize as jopt
from chroma_tpu_torch import bvh as pbvh
from chroma_tpu_torch import make as pmake
from chroma_tpu_torch.bvh import optimize as popt
from tests.test_bvh import check_bvh_valid


def assert_bvh_equal(p, j):
    assert p.nodes.dtype == j.nodes.dtype
    assert np.array_equal(pbvh.from_uint4(p.nodes), jbvh.from_uint4(j.nodes))
    assert list(p.layer_offsets) == list(j.layer_offsets)
    assert np.array_equal(p.world_coords.world_origin,
                          j.world_coords.world_origin)
    assert p.world_coords.world_scale == j.world_coords.world_scale


def shuffled_leaves(bvh_mod, make):
    _, leaves, _ = bvh_mod.create_leaf_nodes(make.sphere(1.0, nsteps=12))
    rng = np.random.RandomState(0)
    return leaves[rng.permutation(len(leaves))]


def test_optimize_layer_matches_jax():
    """Greedy sibling pairing: the same permutation in both, and it
    lowers the summed pair-union area (tests/test_bvh.py:141)."""
    p_in = shuffled_leaves(pbvh, pmake)
    j_in = shuffled_leaves(jbvh, jmake)
    assert np.array_equal(pbvh.from_uint4(p_in), jbvh.from_uint4(j_in))
    p_out, p_perm = popt.optimize_layer(p_in)
    j_out, j_perm = jopt.optimize_layer(j_in)
    assert np.array_equal(p_perm, j_perm)
    assert np.array_equal(pbvh.from_uint4(p_out), jbvh.from_uint4(j_out))
    # chunks smaller than the layer find the same global argmin
    c_out, c_perm = popt.optimize_layer(p_in, chunk=7)
    assert np.array_equal(c_perm, p_perm)

    def paired_area(nodes):
        info = pbvh.unpack_nodes(nodes)
        lo = np.column_stack([info['xlo'], info['ylo'], info['zlo']])
        hi = np.column_stack([info['xhi'], info['yhi'], info['zhi']])
        m = (len(nodes) // 2) * 2
        return sum(popt._pair_area_matrix(lo[i:i + 1], hi[i:i + 1],
                                          lo[i + 1:i + 2],
                                          hi[i + 1:i + 2])[0, 0]
                   for i in range(0, m, 2))

    assert paired_area(p_out) < 0.7 * paired_area(p_in)
    assert sorted(map(tuple, p_out.tolist())) \
        == sorted(map(tuple, p_in.tolist()))


BUILDERS = [('make_recursive_grid_bvh', dict(target_degree=3)),
            ('make_simple_bvh', dict(degree=2)),
            ('make_simple_bvh', dict(degree=3)),
            ('make_simple_bvh', dict(degree=4))]


@pytest.mark.parametrize('builder,kwargs', BUILDERS,
                         ids=['grid3', 'simple2', 'simple3', 'simple4'])
def test_builders_and_area_sort_match_jax(builder, kwargs):
    """The same tree from both packages' builders, the same tree after
    ``area_sort_children``; every triangle still in exactly one
    reachable leaf, and each parent's children by decreasing area."""
    pmesh, jmesh = pmake.sphere(100.0, nsteps=16), jmake.sphere(100.0,
                                                               nsteps=16)
    p = getattr(pbvh, builder)(pmesh, **kwargs)
    j = getattr(jbvh, builder)(jmesh, **kwargs)
    assert_bvh_equal(p, j)
    check_bvh_valid(p, pmesh)

    ps, js = popt.area_sort_children(p), jopt.area_sort_children(j)
    assert_bvh_equal(ps, js)
    check_bvh_valid(ps, pmesh)
    info = pbvh.unpack_nodes(ps.nodes)
    areas = pbvh.node_areas(ps.nodes)
    first_leafless = ps.layer_offsets[1] if len(ps.layer_offsets) > 1 else 0
    for i in range(first_leafless, len(ps.nodes)):
        c0, nc = int(info['child'][i]), int(info['nchild'][i])
        if nc > 1 and c0 >= first_leafless:
            assert (np.diff(areas[c0:c0 + nc]) <= 0).all()
    assert popt.layer_area(ps.nodes) == jopt.layer_area(js.nodes)
    assert popt.layer_area(ps.nodes) == popt.layer_area(p.nodes)


@pytest.mark.parametrize('degree', [2, 3, 5])
def test_merge_nodes_matches_jax(degree):
    """Fixed-degree grouping of Morton-ordered leaves, all-zero padding
    left out of each parent's box and child count."""
    pmesh, jmesh = pmake.cube(10.0), jmake.cube(10.0)
    _, pl, _ = pbvh.create_leaf_nodes(pmesh, round_to_multiple=degree)
    _, jl, _ = jbvh.create_leaf_nodes(jmesh, round_to_multiple=degree)
    p, j = pbvh.merge_nodes(pl, degree), jbvh.merge_nodes(jl, degree)
    assert np.array_equal(pbvh.from_uint4(p), jbvh.from_uint4(j))
    info = pbvh.unpack_nodes(p)
    nreal = int((pbvh.from_uint4(pl)[:, 0] != 0).sum())
    assert int(info['nchild'].sum()) == nreal
    assert len(p) == -(-len(pl) // degree)


def test_layer_slices_and_world_coords_match_jax():
    """``node_areas``, a layer's ``areas_fixed``/``area_fixed``/``area``/
    ``get_bounds``, and ``WorldCoords.world_to_fixed`` with its
    ``OutOfRangeError``, in the shapes of tests/test_bvh.py."""
    p = pbvh.make_recursive_grid_bvh(pmake.cube(100.0), target_degree=3)
    j = jbvh.make_recursive_grid_bvh(jmake.cube(100.0), target_degree=3)
    assert np.array_equal(pbvh.node_areas(p.nodes), jbvh.node_areas(j.nodes))
    for i in range(p.layer_count()):
        pl, jl = p.get_layer(i), j.get_layer(i)
        assert np.array_equal(pl.areas_fixed(), jl.areas_fixed())
        assert pl.area_fixed() == jl.area_fixed()
        assert pl.area() == jl.area()
        for a, b in zip(pl.get_bounds(), jl.get_bounds()):
            assert np.array_equal(a, b)
    areas = [p.get_layer(i).area_fixed() for i in range(p.layer_count())]
    assert areas[0] <= areas[-1]

    pc = pbvh.WorldCoords(world_origin=(-5.0, -5.0, -5.0), world_scale=0.01)
    jc = jbvh.WorldCoords(world_origin=(-5.0, -5.0, -5.0), world_scale=0.01)
    world = np.array([[-5.0, 0.0, 5.0], [1.234, -4.567, 0.0]])
    fixed = pc.world_to_fixed(world)
    assert fixed.dtype == np.uint16
    assert np.array_equal(fixed, jc.world_to_fixed(world))
    assert np.abs(pc.fixed_to_world(fixed) - world).max() <= 0.005 + 1e-6
    with pytest.raises(pbvh.OutOfRangeError):
        pc.world_to_fixed([1000.0, 0, 0])
    assert pbvh.OutOfRangeError is not jbvh.OutOfRangeError


def test_bvh_exports_match_jax():
    """``chroma_tpu_torch.bvh`` exports what ``chroma_tpu.bvh`` does."""
    assert sorted(pbvh.__all__) == sorted(jbvh.__all__)
    for name in pbvh.__all__:
        obj = getattr(pbvh, name)
        if inspect.isfunction(obj) or inspect.isclass(obj):
            assert obj.__module__.startswith('chroma_tpu_torch.'), name
        else:
            assert obj == getattr(jbvh, name), name

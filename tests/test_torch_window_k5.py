"""The window without on-deck slots (K5) as its Hopper kernel reads it:
drained lanes are fixed points, lanes drained at entry, level-1 rows.

csrc/mbvh_walk_window_k5.cu runs no iteration of a drained lane (act 0
and lvl < 0) and stores nothing for it.  On the CPU the kernel cannot
run; these tests hold the properties it relies on against the JAX
Pallas walker (``MP.walk_iter(ondeck=False)`` in interpret mode) and
the port's plain window, from the same start state
(``walker_state_from_jax``):

* a drained lane is a fixed point: after a window in which every walk
  drains, a further window leaves the state bit-identical, in JAX and in
  the port (its window, and ``walk_iter`` stepped over every lane);
  a lane seeded inactive (act 0, lvl >= 0) is not one;
* a state with a third of its lanes drained at entry, at n_iters 1 and
  17, matches JAX within tests/test_torch_window_variants.py's
  tolerances (integer state and rays bit-equal, hit distances within
  4e-6 relative, normals within 2e-5 of their length, instance frame
  within 1e-5), with equal active counts;
* every level-1 row a walk pops is one of the root's children
  [rbase, rbase + rcount) of ``root_seed_args`` (row 0 itself for a
  depth-1 tree), the rows the on-deck windows restart from: at most
  one row a child slot, and the JAX package's row 0 names the same.

Cases: the flat sphere24 and instanced demo.tiny of
tests/test_torch_ondeck.py, ``do_prune`` True and False.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu.bvh.mbvh import HDR_BASE, HDR_KIND
from chroma_tpu.ops import mbvh_pallas as MP
from chroma_tpu_torch import host
from chroma_tpu_torch.ops import mbvh as tmbvh
from chroma_tpu_torch.ops import mbvh_walk
from chroma_tpu_torch.ops.geometry_pack import pack_geometry as port_pack
from tests.test_torch_ondeck import (  # noqa: F401  (fixtures)
    _assert_close, _bits, _np, sphere24, tiny)
from tests.test_torch_window_variants import _jax_plain_state, _run_jax

N = 96
MAX_DRAIN = 400      # iterations: every walk drains well before
CASES = [('sphere24', True), ('sphere24', False), ('tiny', True),
         ('tiny', False)]


def _drained_mask(W):
    """Lanes whose walk has drained (act 0, lvl < 0), JAX layout."""
    u = W['uregs']
    return (u[MP.U_ACT] == 0) & (u[MP.U_LVL].view(np.int32) < 0)


def _assert_same(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert np.array_equal(_bits(a[k]), _bits(b[k])), (what, k)


@pytest.fixture(scope='module', params=CASES,
                ids=['%s-%s' % (c[0], 'prune' if c[1] else 'noprune')
                     for c in CASES])
def drained(request):
    """A seeded JAX state without on-deck slots and the same state after
    JAX windows of 10 iterations until every walk has drained."""
    name, prune = request.param
    jgeom, pgeom = request.getfixturevalue(name)
    W0 = _np(_jax_plain_state(jgeom, N, seed=N + 1))
    W, iters = W0, 0
    while not _drained_mask(W).all():
        assert iters < MAX_DRAIN, 'walks left after %d iterations' % iters
        Wj, _ = _run_jax(jgeom, W, 10, 0, prune)
        W, iters = _np(Wj), iters + 10
    return dict(jgeom=jgeom, pgeom=pgeom, prune=prune, start=W0, end=W,
                depth=int(jgeom.mbvh_depth),
                instanced=bool(jgeom.mbvh_instanced))


def test_drained_state_is_a_jax_fixed_point(drained):
    """Five more iterations of the Pallas walker change no bit."""
    Wj, nactive = _run_jax(drained['jgeom'], drained['end'], 5, 0,
                           drained['prune'])
    assert nactive == 0
    _assert_same(drained['end'], _np(Wj), 'JAX')


def test_drained_state_is_a_port_fixed_point(drained):
    """The plain window and ``walk_iter`` stepped over every lane (as a
    kernel would that did not skip drained lanes) change no bit."""
    d = drained
    pg = d['pgeom']
    W = mbvh_walk.walker_state_from_jax(d['end'], d['depth'],
                                        d['instanced'], 0, 'cpu')
    before = {k: v.clone() for k, v in W.items()}
    count = torch.zeros((), dtype=torch.int64)
    tmbvh.walk_window(pg, W, 5, 0, *mbvh_walk.root_seed_args(pg),
                      prune=d['prune'], nactive=count)
    assert int(count) == 0
    rows = pg.mbvh_rows
    stepped = mbvh_walk.walk_iter(rows[W['ptr'].long()], W, d['depth'],
                                  d['instanced'], tmbvh.tquant_scale(pg),
                                  d['prune'])
    for k, v in before.items():
        for what, got in (('window', W[k]), ('walk_iter', stepped[k])):
            assert torch.equal(_bits_t(got), _bits_t(v)), (what, k)


def _bits_t(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _mix(start, end, every=3):
    """Lanes i % every == 0 from ``end`` (drained), the rest from
    ``start``; JAX layout, lanes on the last axis."""
    lanes = np.arange(start['uregs'].shape[1]) % every == 0
    return {k: np.where(lanes, end[k], start[k]) for k in start}, lanes


@pytest.mark.parametrize('n_iters', [1, 17])
def test_drained_at_entry_matches_pallas(drained, n_iters):
    """A third of the lanes drained at entry and the rest walking (or
    seeded inactive): JAX and the port agree after ``n_iters``, with
    equal active counts, and leave the drained lanes untouched."""
    d = drained
    W0, lanes = _mix(d['start'], d['end'])
    assert _drained_mask(W0)[lanes].all()
    Wj, nj = _run_jax(d['jgeom'], W0, n_iters, 0, d['prune'])
    ref = _np(Wj)
    Wp = mbvh_walk.walker_state_from_jax(W0, d['depth'], d['instanced'], 0,
                                         'cpu')
    count = torch.zeros((), dtype=torch.int64)
    tmbvh.walk_window(d['pgeom'], Wp, n_iters, 0,
                      *mbvh_walk.root_seed_args(d['pgeom']),
                      prune=d['prune'], nactive=count)
    out = mbvh_walk.walker_state_to_jax(Wp, d['depth'], 0)
    _assert_close(ref, out, 0, d['instanced'])
    assert nj == int(count) > 0
    for W in (ref, out):
        for k in W0:
            assert np.array_equal(_bits(W[k][..., lanes]),
                                  _bits(W0[k][..., lanes])), k


def test_seeded_inactive_lane_is_not_a_fixed_point(sphere24):
    """A lane seeded inactive holds act 0 with lvl >= 0 and pops once to
    lvl -1: the kernel must skip on (act 0, lvl < 0), not on act 0."""
    jgeom, pgeom = sphere24
    W0 = _np(_jax_plain_state(jgeom, N, seed=5))
    inactive = (W0['uregs'][MP.U_ACT] == 0)
    assert inactive.any()
    assert (W0['uregs'][MP.U_LVL][inactive].view(np.int32) >= 0).all()
    Wj, _ = _run_jax(jgeom, W0, 1, 0, True)
    lvl = np.asarray(Wj['uregs'][MP.U_LVL]).view(np.int32)
    assert (lvl[inactive] == -1).all()
    Wp = mbvh_walk.walker_state_from_jax(W0, int(jgeom.mbvh_depth), False,
                                         0, 'cpu')
    tmbvh.walk_window(pgeom, Wp, 1, 0, *mbvh_walk.root_seed_args(pgeom))
    assert (Wp['lvl'][torch.from_numpy(inactive)] == -1).all()


def _level1_rows(tables, n=256, iters=40):
    """Rows popped at level 1 (level 0 for a depth-1 tree) by the plain
    window from a seeded state, iteration by iteration."""
    depth = int(tables.mbvh_depth)
    W = mbvh_walk.random_window_state(
        tables.mbvh_rows, depth, bool(tables.mbvh_instanced),
        tmbvh.tquant_scale(tables), n, 0, 3)
    first = min(depth - 1, 1)
    seen = [W['ptr'][W['act'] & (W['lvl'] == first)]]
    for _ in range(iters):
        tmbvh.walk_window(tables, W, 1, 0,
                          *mbvh_walk.root_seed_args(tables))
        seen.append(W['ptr'][W['act'] & (W['lvl'] == first)])
    return torch.cat(seen)


def _assert_level1(tables, jax_row0=None):
    """The rows every walk pops at level 1: [rbase, rbase + rcount) of
    ``root_seed_args``, or row 0 at depth 1."""
    rbase, rcount, _ = mbvh_walk.root_seed_args(tables)
    lo, count = (rbase, rcount) if int(tables.mbvh_depth) >= 2 else (0, 1)
    rows = tables.mbvh_rows
    assert 1 <= count <= mbvh_walk.BRANCH
    assert 0 <= lo and lo + count <= rows.shape[0]
    if jax_row0 is not None:
        assert (rbase, rcount) == (int(jax_row0[HDR_BASE]),
                                   int(jax_row0[HDR_KIND] >> np.uint32(8)))
    level1 = _level1_rows(tables)
    assert level1.numel() > 0
    assert bool(((level1 >= lo) & (level1 < lo + count)).all())
    return lo, count


def test_level1_rows_instanced_tiny(tiny):
    """demo.tiny instanced: the TLAS root's children, checked against
    the JAX package's table."""
    jgeom, pgeom = tiny
    assert pgeom.mbvh_instanced
    _assert_level1(pgeom, np.asarray(jgeom.mbvh_rows[0]))


def test_level1_rows_flat_tiny():
    """demo.tiny packed flat by the port."""
    geo = host.demo.tiny()
    geo.flatten()
    g = port_pack(geo, 'cpu', instancing=False)
    assert not g.mbvh_instanced and int(g.mbvh_depth) >= 3
    assert _assert_level1(g)[1] == 64


def test_level1_rows_flat_sphere24(sphere24):
    jgeom, pgeom = sphere24
    _assert_level1(pgeom, np.asarray(jgeom.mbvh_rows[0]))


def test_level1_rows_depth1():
    """A 48-triangle sphere is one cluster row: every walk pops row 0
    (its header's base and count are its triangles', not rows)."""
    g = port_pack(host.mesh_geometry(host.make.sphere(50.0, nsteps=6)),
                  'cpu')
    assert int(g.mbvh_depth) == 1
    assert _assert_level1(g) == (0, 1)

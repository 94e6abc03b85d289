"""The window without on-deck slots (K5) and without pruning (K6)
against the JAX Pallas walker.

The port's plain window (``walk_window_plain``, the CUDA window kernel's
reference, which it runs on CPU tensors) is held against
``MP.walk_iter`` in interpret mode from the same start state, carried in
by ``walker_state_from_jax``:

* ``od_slots=0`` against ``walk_iter(ondeck=False)``: the flat sphere and
  instanced demo.tiny, a service window of 10 iterations and a long one
  in which every walk drains (a drained walk idles);
* ``prune=False`` against ``walk_iter(do_prune=False)``, without on-deck
  slots and with one and two;
* the active lane-iteration count (``nactive``, the driver's stats[3])
  against the JAX driver's sum of the active flag after each iteration.

Tolerances are tests/test_torch_ondeck.py's: the integer state and the
rays bit-equal, hit distances within 4e-6 relative and normals within
2e-5 of their length (XLA on the CPU contracts a*b+c into fused
multiply-adds, the port rounds each product as its kernel does), the
instance frame within 1e-5.  The counts are equal.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu.bvh.mbvh import HDR_BASE, HDR_KIND
from chroma_tpu.ops import mbvh as jmbvh
from chroma_tpu.ops import mbvh_pallas as MP
from chroma_tpu_torch.ops import mbvh as tmbvh
from chroma_tpu_torch.ops import mbvh_walk
from tests.test_torch_ondeck import (  # noqa: F401  (fixtures)
    _assert_close, _bits, _jax_state, _np, sphere24, tiny)

SHORT, LONG = 10, 200


def _jax_plain_state(jgeom, n, seed):
    """A seeded JAX walker state without on-deck slots (~10% of lanes
    inactive)."""
    W = _jax_state(jgeom, n, 1, seed)
    return {k: W[k] for k in MP.W_KEYS}


def _run_jax(jgeom, W, n_iters, od_slots, prune):
    """``n_iters`` of ``MP.walk_iter``; returns the state and the sum of
    the active flag after each iteration (the JAX driver's nactive)."""
    rows = jgeom.mbvh_rows
    depth = int(jgeom.mbvh_depth)
    kw = dict(block=128, do_prune=prune)
    if od_slots:
        kw.update(ondeck=True, od_slots=od_slots,
                  rbase=rows[0, HDR_BASE].astype(jnp.int32),
                  rcount=(rows[0, HDR_KIND] >> jnp.uint32(8))
                  .astype(jnp.int32),
                  root_lohi=MP.root_boxes_lohi(jgeom))
    nactive = 0
    for _ in range(n_iters):
        ptr = jax.lax.bitcast_convert_type(W['uregs'][MP.U_PTR], jnp.int32)
        W = MP.walk_iter(rows[ptr].T, W, depth, bool(jgeom.mbvh_instanced),
                         jmbvh.tquant_scale(jgeom), **kw)
        nactive += int(jnp.sum(W['uregs'][MP.U_ACT] != 0))
    return W, nactive


CASES = [('sphere24', 0, True), ('tiny', 0, True), ('sphere24', 0, False),
         ('tiny', 0, False), ('tiny', 1, False), ('sphere24', 2, False)]


@pytest.fixture(scope='module', params=CASES,
                ids=['%s-od%d-%s' % (c[0], c[1], 'prune' if c[2] else 'noprune')
                     for c in CASES])
def windows(request):
    """JAX and port states after a short and a long window from the same
    start, with both active lane-iteration counts."""
    name, od_slots, prune = request.param
    jgeom, pgeom = request.getfixturevalue(name)
    depth, inst = int(jgeom.mbvh_depth), bool(jgeom.mbvh_instanced)
    n = 192
    W0 = (_jax_state(jgeom, n, od_slots, seed=n + od_slots) if od_slots
          else _jax_plain_state(jgeom, n, seed=n))
    Wp = mbvh_walk.walker_state_from_jax(_np(W0), depth, inst, od_slots,
                                         'cpu')
    out = dict(start=_np(W0), od_slots=od_slots, instanced=inst, prune=prune)
    Wj = W0
    for label, iters in (('short', SHORT), ('long', LONG - SHORT)):
        Wj, nj = _run_jax(jgeom, Wj, iters, od_slots, prune)
        count = torch.zeros((), dtype=torch.int64)
        tmbvh.walk_window(pgeom, Wp, iters, od_slots,
                          *mbvh_walk.root_seed_args(pgeom), prune=prune,
                          nactive=count)
        out[label] = (_np(Wj), mbvh_walk.walker_state_to_jax(Wp, depth,
                                                             od_slots))
        out[label + '_nactive'] = (nj, int(count))
    return out


@pytest.mark.parametrize('window', ['short', 'long'])
def test_window_matches_pallas(windows, window):
    ref, out = windows[window]
    od_slots = windows['od_slots']
    if od_slots == 0:
        # K5 never writes the rays or the pad word: the state has none of
        # the on-deck keys, and the rays pass through unchanged
        assert sorted(out) == sorted(ref), (sorted(out), sorted(ref))
        assert np.array_equal(_bits(out['rays']),
                              _bits(windows['start']['rays']))
    _assert_close(ref, out, od_slots, windows['instanced'])


@pytest.mark.parametrize('window', ['short', 'long'])
def test_active_count_matches_pallas(windows, window):
    nj, np_ = windows[window + '_nactive']
    assert nj == np_
    if window == 'short':
        assert nj > 0


def test_long_window_drains(windows):
    """After the long window every walk has drained; without on-deck
    slots nothing was parked and the pad word is untouched."""
    ref, out = windows['long']
    assert not (out['uregs'][MP.U_ACT] != 0).any()
    assert (out['uregs'][MP.U_LVL].view(np.int32) < 0).all()
    if windows['od_slots'] == 0:
        assert np.array_equal(out['uregs'][MP.U_PAD],
                              windows['start']['uregs'][MP.U_PAD])


def test_prune_off_walks_at_least_as_long(sphere24):
    """Without pruning no level dies early, so the walks take at least as
    many iterations to drain and find the same nearest triangles."""
    jgeom, pgeom = sphere24
    depth = int(jgeom.mbvh_depth)
    W0 = _np(_jax_plain_state(jgeom, 256, seed=3))
    runs = {}
    for prune in (True, False):
        W = mbvh_walk.walker_state_from_jax(W0, depth, False, 0, 'cpu')
        count = torch.zeros((), dtype=torch.int64)
        tmbvh.walk_window(pgeom, W, LONG, 0, *mbvh_walk.root_seed_args(pgeom),
                          prune=prune, nactive=count)
        assert not W['act'].any()
        runs[prune] = (W, int(count))
    assert runs[False][1] >= runs[True][1] > 0
    assert torch.equal(runs[False][0]['tri'], runs[True][0]['tri'])
    assert torch.equal(runs[False][0]['min_dist'], runs[True][0]['min_dist'])


def test_window_counters_and_refusals(sphere24):
    """CPU state takes the plain window and counts nothing; the CUDA
    wrapper refuses CPU tensors and od_slots outside 0..2; every variant
    has its own launch counter."""
    jgeom, pgeom = sphere24
    W = mbvh_walk.walker_state_from_jax(
        _np(_jax_plain_state(jgeom, 32, seed=1)), int(jgeom.mbvh_depth),
        False, 0, 'cpu')
    keys = [mbvh_walk.window_key(s, p) for s in (0, 1, 2)
            for p in (True, False)]
    assert sorted(map(str, keys)) == sorted(
        map(str, mbvh_walk.walk_window_launches))
    before = {k: c.launches for k, c in
              mbvh_walk.walk_window_launches.items()}
    tmbvh.walk_window(pgeom, W, 3, 0, *mbvh_walk.root_seed_args(pgeom),
                      prune=False)
    assert before == {k: c.launches for k, c in
                      mbvh_walk.walk_window_launches.items()}
    args = (pgeom.mbvh_rows, W, 3, int(pgeom.mbvh_depth), False,
            tmbvh.tquant_scale(pgeom))
    with pytest.raises(ValueError, match='CUDA tensor'):
        mbvh_walk.walk_window_cuda(*args, 0,
                                   *mbvh_walk.root_seed_args(pgeom))
    with pytest.raises(ValueError, match='od_slots'):
        mbvh_walk.walk_window_cuda(*args, 3,
                                   *mbvh_walk.root_seed_args(pgeom))

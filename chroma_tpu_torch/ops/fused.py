"""The on-deck lane-pool propagation driver, at one chain.

Counterpart of chroma_tpu/ops/fused.py (``propagate_fused`` with
``ondeck=True``, ``chains=1``).  Every lane of a fixed width owns one
walking photon and up to ``od_slots`` on-deck photons.  The driver
alternates two phases until every photon has retired:

* a walker window (ops/mbvh.walk_window): ``service_every`` iterations
  over every lane, in one launch of the window kernel on a card.  A walk
  that drains parks its results and restarts on the lane's on-deck ray
  in the same iteration, so a lane idles only once its on-deck slots are
  used up;
* a service pass (``_service_ondeck``): one physics pass
  (ops/propagate.physics_update) over the parked and the drained
  walking photons, the retire scatter of finished photons into the
  packed pool at their own index, then spare redistribution, pool
  refill in rank order, on-deck seeding and the reseed of fresh walks.

Photons ride packed, 16 int32 words a row (``_pack``); the pool is one
(n, 16) array and output order equals input order.  Draws are taken
once per service pass: ``draws(rows)`` returns the next (rows, NDRAWS)
block, rows = (1 + od_slots) * width, one row per photon set.

Not carried over from the JAX driver (TPU scheduling): chains, the
dynamic ``service_frac`` cadence, ``PHYS_BARRIER`` and the
``DRAIN_SHRINK`` compaction of the pool-dry tail.
"""
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.ops import mbvh, mbvh_walk
from chroma_tpu_torch.ops.propagate import (NDRAWS, TERMINAL, i32,
                                            physics_update)

# Lane width and walker iterations between service passes: the best
# pair of the width x service_every sweep of
# tools/profile_torch_propagate.py on the full demo (PERF.md, Findings).
# The window kernel walks one lane per warp, so the width is a number of
# warps, not of threads.
DEFAULT_WIDTH = 65536
SERVICE_EVERY = 17
_NAN_FLAGS = i32(event.NO_HIT | event.NAN_ABORT)


def _pack(state):
    """Photon SoA -> (n, 16) int32 rows, floats as bit patterns: pos[3]
    dir[3] pol[3] wavelength t weight flags lht evidx index."""
    def bits(k):
        v = state[k].view(torch.int32)
        return v if v.dim() == 2 else v[:, None]
    return torch.cat([bits('pos'), bits('dir'), bits('pol'),
                      bits('wavelength'), bits('t'), bits('weight'),
                      state['flags'][:, None],
                      state['last_hit_triangle'][:, None],
                      state['evidx'][:, None],
                      state['index'].to(torch.int32)[:, None]], dim=1)


def _p_f32(p, lo, hi):
    return p[:, lo:hi].view(torch.float32)


def _unpack(arr):
    """(n, 16) int32 rows -> photon SoA (views of ``arr``, but for the
    int64 ``index``)."""
    return dict(pos=_p_f32(arr, 0, 3), dir=_p_f32(arr, 3, 6),
                pol=_p_f32(arr, 6, 9), wavelength=_p_f32(arr, 9, 10)[:, 0],
                t=_p_f32(arr, 10, 11)[:, 0], weight=_p_f32(arr, 11, 12)[:, 0],
                flags=arr[:, 12], last_hit_triangle=arr[:, 13],
                evidx=arr[:, 14], index=arr[:, 15].to(torch.int64))


def _p_posdir_ok(p):
    """Alive-and-finite predicate of packed rows: no terminal flag and
    no NaN in pos/dir."""
    ok = ~torch.isnan(_p_f32(p, 0, 3).sum(dim=1) + _p_f32(p, 3, 6).sum(dim=1))
    return ok & ((p[:, 12] & TERMINAL) == 0)


def uniform_draws(generator):
    """A draw source for ``propagate_fused``: ``draws(rows)`` returns a
    fresh (rows, NDRAWS) block of uniforms from ``generator``."""
    def draws(rows):
        return torch.rand((rows, NDRAWS), generator=generator,
                          device=generator.device)
    return draws


def _seed_walk(tables, p, need):
    """Walker state for packed photons ``p``, walking where ``need``."""
    return mbvh_walk.seed(tables.mbvh_rows, int(tables.mbvh_depth),
                          bool(tables.mbvh_instanced),
                          mbvh.tquant_scale(tables),
                          _p_f32(p, 0, 3).contiguous(),
                          _p_f32(p, 3, 6).contiguous(),
                          p[:, 13].contiguous(), need)


def _make_lane(packed, tables, w, od_slots):
    """Lane state holding pool photons [0, w): the photon rows ``pk``,
    their step counts, the walker state ``W`` (``window_layout``, as
    the window kernel reads it) with empty on-deck and park fields, and
    empty on-deck photon slots."""
    pk = packed[:w].clone()
    dev = pk.device
    W = _seed_walk(tables, pk, _p_posdir_ok(pk))
    W.update(mbvh_walk.ondeck_empty(w, od_slots, dev))
    lane = dict(pk=pk, W=mbvh_walk.window_layout(W),
                holding=torch.ones(w, dtype=torch.bool, device=dev),
                step=torch.zeros(w, dtype=torch.int32, device=dev))
    for pre in ('odk', 'odk2')[:od_slots]:
        lane.update({pre + '_packed': torch.zeros_like(pk),
                     pre + '_step': torch.zeros_like(lane['step']),
                     pre + '_live': torch.zeros_like(lane['holding'])})
    return lane


def _service_ondeck(lane, pool, next_ptr, draws, tables, max_steps,
                    scatter_first, od_slots, use_weights=False):
    """One service pass over a lane set, in place on ``lane`` and
    ``pool``; returns the new refill pointer.

    ``pool`` is the packed photon pool plus one last row that takes the
    retire scatter's dropped writes.  Each lane has 1 + ``od_slots``
    photon slots: WALKING (live walker registers) and one or two ON-DECK
    slots (``odk_packed``, ``odk2_packed``).  The window's swap cascade
    moves on-deck photons into the walking registers mid-window, parking
    finished walks' results, so the packed storage lags until this pass
    reconciles it.  Storage by (parked, parked2) pad bits:

      (0, *) -> ``pk`` = walking photon; odk/odk2 unconsumed if live
      (1, 0) -> ``pk`` = photon A (results in park); walking photon =
                odk_packed; odk2 unconsumed if live
      (1, 1) -> ``pk`` = photon A (park); odk_packed = photon B (park2);
                walking photon = odk2_packed

    After physics, surviving parked photons and unconsumed on-deck
    photons become the lane's spares (at most one per on-deck slot of
    origin); slots refill walking-first, then od1, then od2, spares
    before pool.  od2 is never filled on a lane whose od1 slot is empty
    (the cascade consumes od1 first)."""
    W = lane['W']
    w = lane['pk'].shape[0]
    n_pool = pool.shape[0] - 1
    nsets = 1 + od_slots
    u = draws(nsets * w)
    dev = u.device
    holding, act = lane['holding'], W['act'].clone()
    pk, step = lane['pk'], lane['step']

    # ---- the photon sets: parked A (B), walking L ----------------------
    resA = mbvh_walk.park_results(W, 'park')
    parked = resA.pop('parked')
    res_sets = [resA]
    pk_parts, step_parts = [pk], [step]
    ready_parts = [parked]
    if od_slots == 2:
        resB = mbvh_walk.park_results(W, 'park2')
        parked2 = resB.pop('parked')
        res_sets.append(resB)
        pk_parts.append(lane['odk_packed'])
        step_parts.append(lane['odk_step'])
        ready_parts.append(parked2)
        pkW = torch.where(parked2[:, None], lane['odk2_packed'],
                          torch.where(parked[:, None], lane['odk_packed'],
                                      pk))
        stepW = torch.where(parked2, lane['odk2_step'],
                            torch.where(parked, lane['odk_step'], step))
    else:
        pkW = torch.where(parked[:, None], lane['odk_packed'], pk)
        stepW = torch.where(parked, lane['odk_step'], step)
    res_sets.append(mbvh_walk.results(W))
    pk_parts.append(pkW)
    step_parts.append(stepW)
    ready_parts.append(holding & ~act)
    ALL = torch.cat(pk_parts)
    BIG = _unpack(ALL)
    RES = {k: torch.cat([r[k] for r in res_sets]) for k in res_sets[-1]
           if k != 'incomplete'}
    RES['incomplete'] = torch.zeros(nsets * w, dtype=torch.bool, device=dev)
    step2 = torch.cat(step_parts)

    # ---- one physics pass over every set -------------------------------
    aliveB = (BIG['flags'] & TERMINAL) == 0
    bad = torch.isnan(BIG['dir'].sum(dim=1) + BIG['pos'].sum(dim=1))
    ready = torch.cat(ready_parts) & aliveB & (step2 < max_steps)
    nan_mask = ready & bad
    flags = torch.where(nan_mask, BIG['flags'] | _NAN_FLAGS, BIG['flags'])
    sf = torch.where(step2 == 0, scatter_first, 0)
    new = physics_update(BIG, RES, tables, u, flags, ready & ~bad, nan_mask,
                         sf, use_weights=use_weights)
    step2 = step2 + ready.to(torch.int32)
    # rows the pass did not advance keep their exact words
    PK2 = torch.where(ready[:, None], _pack(new), ALL)
    flags2, idx2 = new['flags'], new['index']

    def sl(v, g):
        return v[g * w:(g + 1) * w]

    # ---- retire every finished photon with one scatter -----------------
    def fin_cont(g, pred):
        fin = pred & (((sl(flags2, g) & TERMINAL) != 0)
                      | (sl(step2, g) >= max_steps))
        idx = torch.where(fin, sl(idx2, g), n_pool)
        return fin, pred & ~fin, idx

    gL = nsets - 1
    packedA, packedW = sl(PK2, 0), sl(PK2, gL)
    stepA2, stepW2 = sl(step2, 0), sl(step2, gL)
    _, contA, idxA = fin_cont(0, parked)
    _, contW, idxW = fin_cont(gL, holding & ~act)
    ret_idx, ret_dat = [idxA, idxW], [packedA, packedW]
    if od_slots == 2:
        packedB, stepB2 = sl(PK2, 1), sl(step2, 1)
        _, contB, idxB = fin_cont(1, parked2)
        ret_idx.append(idxB)
        ret_dat.append(packedB)
    idx = torch.cat(ret_idx)
    # out-of-range rows are dropped (jax's mode='drop') into the last row
    idx = torch.where((idx >= 0) & (idx < n_pool), idx, n_pool)
    pool.index_copy_(0, idx, torch.cat(ret_dat))

    # ---- spares: one per on-deck slot of origin ------------------------
    busy = act
    walk_stay = busy | contW
    walk_free = ~walk_stay
    s1ex = contA | (lane['odk_live'] & ~parked)
    s1p = torch.where(parked[:, None], packedA, lane['odk_packed'])
    s1s = torch.where(parked, stepA2, lane['odk_step'])
    if od_slots == 2:
        s2ex = contB | (lane['odk2_live'] & ~parked2)
        s2p = torch.where(parked2[:, None], packedB, lane['odk2_packed'])
        s2s = torch.where(parked2, stepB2, lane['odk2_step'])
    else:
        s2ex = torch.zeros_like(s1ex)
        s2p, s2s = s1p, s1s

    def grab_idx(fill, next_ptr):
        # pool slots in rank order of the lanes that fill
        rank = torch.cumsum(fill.to(torch.int64), 0) - 1
        grab = next_ptr + rank
        have = fill & (grab < n_pool)
        return have, torch.clamp(grab, 0, n_pool - 1), next_ptr + fill.sum()

    # walking slot: keep -> s1 -> s2 -> pool
    useS1w = walk_free & s1ex
    useS2w = walk_free & ~s1ex & s2ex
    have1, src1, next_ptr = grab_idx(walk_free & ~s1ex & ~s2ex, next_ptr)
    holding_next = walk_stay | useS1w | useS2w | have1
    # od1 slot: first remaining spare -> pool
    s1rem = s1ex & ~useS1w
    s2rem = s2ex & ~useS2w
    use1S1 = s1rem
    use1S2 = s2rem & ~s1rem
    have2, src2, next_ptr = grab_idx(holding_next & ~use1S1 & ~use1S2,
                                     next_ptr)
    odk_live_next = use1S1 | use1S2 | have2
    srcs = [src1, src2]
    if od_slots == 2:
        # od2 slot: the remaining spare -> pool, only where od1 is live
        use2S2 = s2rem & ~use1S2
        have3, src3, next_ptr = grab_idx(
            holding_next & odk_live_next & ~use2S2, next_ptr)
        srcs.append(src3)
    # every grab lies in the refill window; gathered after the retire
    # scatter, which touches only rows below the window
    poolp = pool[torch.cat(srcs)]

    def pick(*pairs, default):
        out = default
        for cond, val in reversed(pairs):
            out = torch.where(cond[:, None] if val.dim() == 2 else cond,
                              val, out)
        return out

    zero = torch.zeros_like(stepW2)
    lane['pk'] = new_packed = pick(
        (walk_stay, packedW), (useS1w, s1p), (useS2w, s2p),
        (have1, poolp[:w]), default=packedW)
    lane['step'] = pick((walk_stay, stepW2), (useS1w, s1s), (useS2w, s2s),
                        default=zero)
    lane['holding'] = holding_next
    lane['odk_packed'] = pick((use1S1, s1p), (use1S2, s2p),
                              (have2, poolp[w:2 * w]),
                              default=lane['odk_packed'])
    lane['odk_step'] = pick((use1S1, s1s), (use1S2, s2s), default=zero)
    lane['odk_live'] = odk_live_next
    if od_slots == 2:
        lane['odk2_packed'] = pick((use2S2, s2p),
                                   (have3, poolp[2 * w:3 * w]),
                                   default=lane['odk2_packed'])
        lane['odk2_step'] = pick((use2S2, s2s), default=zero)
        lane['odk2_live'] = use2S2 | have3

    # ---- clear the swap bits, seed the on-deck slots, reseed walks ------
    W['pad'].zero_()
    for slot, pre in ((1, 'odk'), (2, 'odk2'))[:od_slots]:
        op = lane[pre + '_packed']
        od = mbvh_walk.od_slot_seed(
            _p_f32(op, 0, 3), _p_f32(op, 3, 6), op[:, 13],
            lane[pre + '_live'] & _p_posdir_ok(op), slot)
        for k, v in od.items():
            W[k].copy_(v)
    need = (holding_next & ~busy & _p_posdir_ok(new_packed)
            & (lane['step'] < max_steps))
    fresh = _seed_walk(tables, new_packed, need)
    for k, v in fresh.items():
        nd = need.view((-1,) + (1,) * (v.dim() - 1))
        W[k].copy_(torch.where(nd, v, W[k]))
    return next_ptr


def propagate_fused(state, tables, draws, max_steps=100, width=None,
                    service_every=SERVICE_EVERY, od_slots=1,
                    scatter_first=0, use_weights=False,
                    plain_walker=False):
    """Propagate every photon of ``state`` to termination or
    ``max_steps``, with the on-deck lane-pool driver at one chain.

    ``state``: photon SoA (ops/propagate.make_photon_state); ``tables``
    on the same device; ``draws(rows)`` returns the next (rows, NDRAWS)
    uniform block; ``width`` lanes (default ``DEFAULT_WIDTH``, at most
    the batch); ``od_slots`` 1 or 2 on-deck photons per lane;
    ``scatter_first`` (+1 force / -1 forbid) applies where a photon's
    own step count is 0; ``use_weights`` is ``physics_update``'s;
    ``plain_walker=True`` runs the walker window's
    plain version even on a card (ops/mbvh.walk_window).

    Returns ``(final_state, stats)``: the photons in input order with
    the caller's ``index``, and int32[4] [service passes, photon-steps,
    lane-iterations, 0]."""
    if od_slots not in (1, 2):
        raise ValueError('od_slots must be 1 or 2, got %r' % (od_slots,))
    n = state['pos'].shape[0]
    dev = state['pos'].device
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    caller_index = state['index']
    if n == 0:
        return dict(state), stats.to(torch.int32)
    # re-indexed 0..n-1: retiring photons scatter to their own pool row
    packed = _pack(dict(state, index=torch.arange(n, device=dev)))
    w = min(width or DEFAULT_WIDTH, n)
    pool = torch.cat([packed, torch.zeros_like(packed[:1])])
    lane = _make_lane(packed, tables, w, od_slots)
    next_ptr = torch.tensor(w, dtype=torch.int64, device=dev)
    rbase, rcount, root_lohi = mbvh_walk.root_seed_args(tables)
    while bool(lane['holding'].any()):
        W = lane['W']
        mbvh.walk_window(tables, W, service_every, od_slots, rbase, rcount,
                         root_lohi, plain=plain_walker)
        holding = lane['holding']
        ready = (holding & ~W['act']).sum() + ((W['pad'] & 1) != 0).sum()
        if od_slots == 2:
            ready = ready + ((W['pad'] & 4) != 0).sum()
        stats += torch.stack([torch.ones_like(ready), ready,
                              holding.sum() * service_every,
                              torch.zeros_like(ready)])
        next_ptr = _service_ondeck(lane, pool, next_ptr, draws, tables,
                                   max_steps, scatter_first, od_slots,
                                   use_weights)
    out = {k: v.clone() for k, v in _unpack(pool[:n]).items()}
    out['index'] = caller_index
    return out, stats.to(torch.int32)

"""The lane-pool propagation driver.

Counterpart of chroma_tpu/ops/fused.py (``propagate_fused`` with the
Pallas walker).  Every lane of a fixed width owns one walking photon
and, on the on-deck path, up to ``od_slots`` on-deck photons.  The
driver alternates two phases until every photon has retired:

* a walker window (ops/mbvh.walk_window): ``service_every`` iterations
  over every lane, in one launch of the window kernel on a card.  On
  the on-deck path (the default) a walk that drains parks its results
  and restarts on the lane's on-deck ray in the same iteration, so a
  lane idles only once its on-deck slots are used up; with
  ``ondeck=False`` a drained walk idles until the next service pass;
* a service pass (``_service_ondeck``, or ``_service`` without on-deck
  slots): one physics pass (ops/propagate.physics_update) over the
  parked and the drained walking photons, the retire scatter of
  finished photons into the packed pool at their own index, then (on
  the on-deck path) spare redistribution, pool refill in rank order,
  on-deck seeding and the reseed of fresh walks.

Photons ride packed, 16 int32 words a row (``_pack``); the pool is one
(n, 16) array and output order equals input order.  Draws are taken
once per service pass: ``draws(rows)`` returns the next (rows, NDRAWS)
block, rows = (1 + od_slots) * width, one row per photon set.

The JAX driver's other knobs, with its meaning:

* ``chains``: the lanes and the pool split into segments (the pool's
  sizes differing by at most one), a chain's lanes refilling only from
  its own segment; one merged service pass over all chains.  Here the
  chains are contiguous blocks of one lane set, walked by one launch;
* ``service_frac``: the dynamic cadence: one walker iteration at a time
  (without on-deck slots), a chain serviced once its drained lanes reach
  ``service_frac`` of its width (or all its holding lanes);
* ``drain_shrink``: at widths above ``DRAIN_MIN_WIDTH``, once the pool
  is dry and few lanes still hold photons, the holding lanes are
  stable-partitioned to the front (``_compact_lanes``) and the driver
  goes on at 1/8 of the width, then at 1/64;
* ``prune='off'``: the walker keeps every level with a pending child
  live (K6);
* ``collect_stats``: stats[3], the active lane-iterations, counted in
  the window kernel.

Not carried over (TPU scheduling, no change to what is computed):
``PHYS_BARRIER``, ``MOCK_F32V`` and the Pallas lane tile ``block``.
"""
import torch

from chroma_tpu_torch import event, tracing
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
# Chains are the JAX driver's pipelining of row gathers under other
# chains' arithmetic on a TPU; one launch walks every lane here, so the
# port defaults to one.
DEFAULT_CHAINS = 1
MIN_CHAIN_WIDTH = 2048  # fewer lanes or photons a chain: fewer chains
# The pool-dry tail: above DRAIN_MIN_WIDTH lanes, compact to 1/8 and
# then 1/64 of each chain's width, but to no fewer than DRAIN_MIN_LANES
# lanes in all (the JAX driver's cascade).
DRAIN_SHRINK = (8, 64)
DRAIN_MIN_WIDTH = 4096
DRAIN_MIN_LANES = 1024
PRUNE_MODES = ('on', 'half', 'off')
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


class Chains(object):
    """Chain c holds lanes [lane_lo[c], lane_lo[c + 1]) of the lane set
    and refills them from pool rows [seg_lo[c], seg_lo[c + 1])."""

    def __init__(self, lane_lo, seg_lo, device):
        self.lane_lo = [int(x) for x in lane_lo]
        self.seg_lo = [int(x) for x in seg_lo]
        self.n = len(self.lane_lo) - 1
        self._lo = torch.tensor(self.lane_lo, device=device)
        sizes = torch.tensor([b - a for a, b in zip(self.lane_lo,
                                                    self.lane_lo[1:])])
        self.cid = torch.repeat_interleave(
            torch.arange(self.n), sizes).to(device)
        self.seg_hi = torch.tensor(self.seg_lo[1:], device=device)

    def widths(self):
        return [b - a for a, b in zip(self.lane_lo, self.lane_lo[1:])]

    def per_chain(self, x):
        """Sum of ``x`` (w,) over each chain's lanes, int64 (C,)."""
        cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=x.device),
                        torch.cumsum(x.to(torch.int64), 0)])
        return cs[self._lo[1:]] - cs[self._lo[:-1]]

    def grab(self, fill, next_ptr, n_pool):
        """Pool rows for the lanes that ``fill``, in rank order within
        each chain from its pointer ``next_ptr`` (C,): (have, row,
        advanced pointers); ``have`` is False past a chain's segment."""
        cs = torch.cumsum(fill.to(torch.int64), 0)
        before = torch.cat([torch.zeros(1, dtype=cs.dtype, device=cs.device),
                            cs])[self._lo[:-1]]
        row = next_ptr[self.cid] + cs - 1 - before[self.cid]
        have = fill & (row < self.seg_hi[self.cid])
        return have, torch.clamp(row, 0, n_pool - 1), \
            next_ptr + self.per_chain(fill)


def _seed_walk(tables, p, need):
    """Walker state for packed photons ``p``, walking where ``need``."""
    return mbvh_walk.seed(tables.mbvh_rows, int(tables.mbvh_depth),
                          bool(tables.mbvh_instanced),
                          mbvh.tquant_scale(tables),
                          _p_f32(p, 0, 3).contiguous(),
                          _p_f32(p, 3, 6).contiguous(),
                          p[:, 13].contiguous(), need)


def _make_lane(packed, tables, chains, od_slots):
    """Lane state holding each chain's first pool photons: the photon
    rows ``pk``, their step counts, the walker state ``W``
    (``window_layout``, as the window kernel reads it) and, on the
    on-deck path (``od_slots`` > 0), empty on-deck and park fields and
    empty on-deck photon slots."""
    pk = torch.cat([packed[lo:lo + w] for lo, w in
                    zip(chains.seg_lo, chains.widths())])
    w = pk.shape[0]
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


def _reseed(W, tables, pk, need):
    """Fresh walks from the packed photons ``pk`` where ``need``."""
    fresh = _seed_walk(tables, pk, need)
    for k, v in fresh.items():
        nd = need.view((-1,) + (1,) * (v.dim() - 1))
        W[k].copy_(torch.where(nd, v, W[k]))


def _one_chain(pool, next_ptr, w, chains):
    if chains is None:
        chains = Chains([0, w], [0, pool.shape[0] - 1], pool.device)
    return chains, next_ptr.reshape(-1)


def _service(lane, pool, next_ptr, draws, tables, max_steps, scatter_first,
             use_weights=False, chains=None, serve=None):
    """One service pass without on-deck slots (the JAX driver's
    ``_service`` and ``_service_all``), in place on ``lane`` and
    ``pool``; returns the new refill pointers (``next_ptr``'s shape).

    Lanes whose walk has drained get one physics pass (one draw row a
    lane); finished photons (terminal, or out of steps) are written to
    their pool row, and their lanes refill from their chain's segment
    in rank order and start a fresh walk.  ``serve`` (w,) bool, if
    given, limits the pass to those lanes (the chains the dynamic
    cadence services).  ``pool`` has one last row that takes the retire
    scatter's dropped writes."""
    W = lane['W']
    w = lane['pk'].shape[0]
    n_pool = pool.shape[0] - 1
    shape = next_ptr.shape
    chains, next_ptr = _one_chain(pool, next_ptr, w, chains)
    u = draws(w)
    holding, pk, step = lane['holding'], lane['pk'], lane['step']
    trav_done = ~W['act']
    if serve is not None:
        trav_done = trav_done & serve
    P = _unpack(pk)
    alive = (P['flags'] & TERMINAL) == 0
    bad = torch.isnan(P['dir'].sum(dim=1) + P['pos'].sum(dim=1))
    ready = holding & alive & trav_done & (step < max_steps)
    nan_mask = ready & bad
    flags = torch.where(nan_mask, P['flags'] | _NAN_FLAGS, P['flags'])
    res = mbvh_walk.results(W)
    res = dict(res, incomplete=torch.zeros_like(res['incomplete']))
    sf = torch.where(step == 0, scatter_first, 0)
    new = physics_update(P, res, tables, u, flags, ready & ~bad, nan_mask,
                         sf, use_weights=use_weights)
    step = step + ready.to(torch.int32)
    # rows the pass did not advance keep their exact words
    packed = torch.where(ready[:, None], _pack(new), pk)

    # ---- retire, then refill from the chain's segment -----------------
    finished = holding & trav_done & (((packed[:, 12] & TERMINAL) != 0)
                                      | (step >= max_steps))
    idx = torch.where(finished, packed[:, 15].to(torch.int64), n_pool)
    idx = torch.where((idx >= 0) & (idx < n_pool), idx, n_pool)
    pool.index_copy_(0, idx, packed)
    have, src, next_ptr = chains.grab(finished, next_ptr, n_pool)
    lane['pk'] = new_pk = torch.where(have[:, None], pool[src], packed)
    lane['step'] = torch.where(have, 0, step)
    lane['holding'] = (holding & ~finished) | have

    # ---- fresh walks for lanes starting their next step ---------------
    need = (lane['holding'] & trav_done & _p_posdir_ok(new_pk)
            & (lane['step'] < max_steps))
    _reseed(W, tables, new_pk, need)
    return next_ptr.reshape(shape)


def _service_ondeck(lane, pool, next_ptr, draws, tables, max_steps,
                    scatter_first, od_slots, use_weights=False, chains=None):
    """One service pass over a lane set, in place on ``lane`` and
    ``pool``; returns the new refill pointers (``next_ptr``'s shape).

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
    before pool, each chain from its own pool segment (``chains``;
    None: one chain over the whole pool).  od2 is never filled on a lane
    whose od1 slot is empty (the cascade consumes od1 first)."""
    W = lane['W']
    w = lane['pk'].shape[0]
    n_pool = pool.shape[0] - 1
    shape = next_ptr.shape
    chains, next_ptr = _one_chain(pool, next_ptr, w, chains)
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

    # walking slot: keep -> s1 -> s2 -> pool
    useS1w = walk_free & s1ex
    useS2w = walk_free & ~s1ex & s2ex
    have1, src1, next_ptr = chains.grab(walk_free & ~s1ex & ~s2ex,
                                        next_ptr, n_pool)
    holding_next = walk_stay | useS1w | useS2w | have1
    # od1 slot: first remaining spare -> pool
    s1rem = s1ex & ~useS1w
    s2rem = s2ex & ~useS2w
    use1S1 = s1rem
    use1S2 = s2rem & ~s1rem
    have2, src2, next_ptr = chains.grab(holding_next & ~use1S1 & ~use1S2,
                                        next_ptr, n_pool)
    odk_live_next = use1S1 | use1S2 | have2
    srcs = [src1, src2]
    if od_slots == 2:
        # od2 slot: the remaining spare -> pool, only where od1 is live
        use2S2 = s2rem & ~use1S2
        have3, src3, next_ptr = chains.grab(
            holding_next & odk_live_next & ~use2S2, next_ptr, n_pool)
        srcs.append(src3)
    # every grab lies in its chain's refill window; gathered after the
    # retire scatter, which touches only rows below the windows
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
    _reseed(W, tables, new_packed, need)
    return next_ptr.reshape(shape)


def _compact_order(holding, m):
    """The first ``m`` lanes of the stable partition that puts holding
    lanes first (the JAX driver's ``_compact_lanes`` permutation)."""
    n = holding.shape[0]
    h = holding.to(torch.int64)
    cnt = torch.cumsum(h, 0)
    rank_dead = torch.cumsum(1 - h, 0) - 1
    dest = torch.where(holding, cnt - 1, cnt[-1] + rank_dead)
    src = torch.empty_like(dest)
    src[dest] = torch.arange(n, device=holding.device)
    return src[:m]


def _compact_lanes(lane, chains, targets):
    """Keep ``targets[c]`` lanes of chain c, its holding lanes first in
    their order: the lane set and its walker state gathered once, in
    ``window_layout``.  Returns (lane, chains)."""
    idx = torch.cat([lo + _compact_order(lane['holding'][lo:hi], m)
                     for lo, hi, m in zip(chains.lane_lo, chains.lane_lo[1:],
                                          targets)])
    out = {k: v[idx] for k, v in lane.items() if k != 'W'}
    out['W'] = mbvh_walk.window_layout(
        {k: v[idx] for k, v in lane['W'].items()})
    lane_lo = [0]
    for m in targets:
        lane_lo.append(lane_lo[-1] + m)
    return out, Chains(lane_lo, chains.seg_lo, idx.device)


def _segments(n, w_total, nchains):
    """(pool segment starts, chain widths): segments differing by at
    most one photon, each chain at most ``w_total // nchains`` lanes."""
    while nchains > 1 and (w_total // nchains < MIN_CHAIN_WIDTH
                           or n // nchains < MIN_CHAIN_WIDTH):
        nchains -= 1
    base, rem = divmod(n, nchains)
    sizes = [base + (1 if c < rem else 0) for c in range(nchains)]
    seg_lo = [0]
    for s in sizes:
        seg_lo.append(seg_lo[-1] + s)
    return seg_lo, [min(w_total // nchains, s) for s in sizes]


def propagate_fused(state, tables, draws, max_steps=100, width=None,
                    service_every=SERVICE_EVERY, od_slots=1,
                    scatter_first=0, use_weights=False,
                    plain_walker=False, ondeck=True, prune='on',
                    service_frac=None, drain_shrink=DRAIN_SHRINK,
                    chains=DEFAULT_CHAINS, collect_stats=False):
    """Propagate every photon of ``state`` to termination or
    ``max_steps`` with the lane-pool driver.

    ``state``: photon SoA (ops/propagate.make_photon_state); ``tables``
    on the same device; ``draws(rows)`` returns the next (rows, NDRAWS)
    uniform block; ``width`` lanes in all chains (default
    ``DEFAULT_WIDTH``, at most the batch); ``od_slots`` 1 or 2 on-deck
    photons per lane; ``scatter_first`` (+1 force / -1 forbid) applies
    where a photon's own step count is 0; ``use_weights`` is
    ``physics_update``'s; ``plain_walker=True`` runs the walker window's
    plain version even on a card (ops/mbvh.walk_window).

    As the JAX driver: ``ondeck=False`` walks without on-deck slots (K5
    windows; a drained walk waits for the service pass); ``prune`` 'on'
    or 'half' prune every pop (the Pallas walker's rule), 'off' never;
    ``service_frac`` selects the dynamic cadence (and ``ondeck=False``):
    one walker iteration a launch, and after each one host read of the
    chains' holding and drained counts decides whether to service;
    ``drain_shrink`` the compaction factors of the pool-dry tail (``()``
    turns it off); ``chains`` the number of pool segments (fewer when a
    chain would have fewer than ``MIN_CHAIN_WIDTH`` lanes or photons);
    ``collect_stats`` counts stats[3] in the window.

    Returns ``(final_state, stats)``: the photons in input order with
    the caller's ``index``, and int32[4] [service passes, photon-steps,
    lane-iterations, active lane-iterations (0 without
    ``collect_stats``)]."""
    if od_slots not in (1, 2):
        raise ValueError('od_slots must be 1 or 2, got %r' % (od_slots,))
    if prune not in PRUNE_MODES:
        raise ValueError('prune must be one of %s, got %r'
                         % (PRUNE_MODES, prune))
    ondeck = bool(ondeck) and service_frac is None
    od = od_slots if ondeck else 0
    n = state['pos'].shape[0]
    dev = state['pos'].device
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    caller_index = state['index']
    if n == 0:
        return dict(state), stats.to(torch.int32)
    # re-indexed 0..n-1: retiring photons scatter to their own pool row
    packed = _pack(dict(state, index=torch.arange(n, device=dev)))
    w_total = min(width or DEFAULT_WIDTH, n)
    seg_lo, w_c = _segments(n, w_total, max(int(chains or 1), 1))
    lane_lo = [0]
    for w in w_c:
        lane_lo.append(lane_lo[-1] + w)
    ch = Chains(lane_lo, seg_lo, dev)
    pool = torch.cat([packed, torch.zeros_like(packed[:1])])
    lane = _make_lane(packed, tables, ch, od)
    next_ptr = torch.tensor([lo + w for lo, w in zip(seg_lo, w_c)],
                            dtype=torch.int64, device=dev)
    walk = dict(plain=plain_walker, prune=prune != 'off',
                nactive=stats[3] if collect_stats else None)
    root = mbvh_walk.root_seed_args(tables)
    svc = (draws, tables, max_steps, scatter_first)

    def more(nhold, ptrs, targets):
        """The JAX driver's ``run_stage`` condition, per chain."""
        return any(h > 0 and (targets is None or p < hi or h > t)
                   for h, p, hi, t in zip(
                       nhold, ptrs, ch.seg_lo[1:],
                       targets or [None] * ch.n))

    def static_stage(lane, next_ptr, targets):
        while True:
            nhold = ch.per_chain(lane['holding'])
            with tracing.span('pass.wait'):
                counts = torch.stack([nhold, next_ptr]).tolist()
            if not more(*counts, targets):
                return lane, next_ptr
            W = lane['W']
            with tracing.span('pass.walk'):
                mbvh.walk_window(tables, W, service_every, od, *root, **walk)
            holding = lane['holding']
            ready = (holding & ~W['act']).sum()
            if od:
                ready = ready + ((W['pad'] & 1) != 0).sum()
            if od == 2:
                ready = ready + ((W['pad'] & 4) != 0).sum()
            stats[:3] += torch.stack([torch.ones_like(ready), ready,
                                      holding.sum() * service_every])
            with tracing.span('pass.service'):
                if od:
                    next_ptr = _service_ondeck(lane, pool, next_ptr, *svc,
                                               od, use_weights, ch)
                else:
                    next_ptr = _service(lane, pool, next_ptr, *svc,
                                        use_weights, ch)

    def dynamic_stage(lane, next_ptr, targets):
        while True:
            W = lane['W']
            with tracing.span('pass.walk'):
                mbvh.walk_window(tables, W, 1, 0, *root, **walk)
            holding = lane['holding']
            with tracing.span('pass.wait'):
                nhold, ndone, ptrs = torch.stack([
                    ch.per_chain(holding), ch.per_chain(holding & ~W['act']),
                    next_ptr]).tolist()
            if not more(nhold, ptrs, targets):
                return lane, next_ptr
            stats[2] += sum(nhold)
            due = [h > 0 and d >= min(max(1, int(service_frac * w)), h)
                   for h, d, w in zip(nhold, ndone, ch.widths())]
            if not any(due):
                continue
            stats[0] += 1
            stats[1] += sum(d for d, u in zip(ndone, due) if u)
            serve = torch.tensor(due, device=dev)[ch.cid]
            with tracing.span('pass.service'):
                next_ptr = _service(lane, pool, next_ptr, *svc, use_weights,
                                    ch, serve)

    stage = dynamic_stage if service_frac is not None else static_stage
    if min(w_c) * ch.n > DRAIN_MIN_WIDTH:
        for shrink in drain_shrink:
            targets = [min(max(w // shrink, DRAIN_MIN_LANES // ch.n), w)
                       for w in w_c]
            lane, next_ptr = stage(lane, next_ptr, targets)
            lane, ch = _compact_lanes(lane, ch, targets)
    stage(lane, next_ptr, None)
    out = {k: v.clone() for k, v in _unpack(pool[:n]).items()}
    out['index'] = caller_index
    return out, stats.to(torch.int32)

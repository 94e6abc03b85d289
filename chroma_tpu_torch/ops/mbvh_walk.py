"""The MBVH walker: CUDA kernels and their plain PyTorch versions.

Counterpart of chroma_tpu/ops/mbvh_pallas.py.  Two walks:

The closest-hit walk computes what ``intersect_mesh_pallas`` computes:
``seed`` (the root's children slab-tested and the nearest one popped),
``walk_iter`` until no ray is active, then ``results``.

* ``closest_hit_cuda`` launches csrc/mbvh_walk.cu: one warp per ray,
  each walk run to completion in one launch.
* ``closest_hit_plain`` is vectorized torch with the same pending-code
  semantics, one iteration per loop trip over the rays still walking
  (an inactive ray's state never changes, so stepping only the active
  ones is the same walk).  Every a*b+c rounds twice here, as in the
  kernel, which is built with --fmad=false: the two agree bit for bit.

The on-deck window runs ``n_iters`` iterations of ``walk_iter(ondeck=
True)`` over every lane of the fused driver (ops/fused.py): a walk that
drains parks its results and restarts on the lane's on-deck ray within
the same iteration (K3; K4 with a second slot).

* ``walk_window_cuda`` launches csrc/mbvh_walk_window.cu: one warp per
  lane, the lane state in device memory across launches.
* ``walk_window_plain`` is the same in vectorized torch, stepping only
  the lanes whose state can still change (a drained lane with no
  on-deck ray left is a fixed point).  Bit-equal to the kernel.

State is lanes-first: ``tcodes`` (n, S, BRANCH) int32 holds the
unbiased 16-bit entry codes of each pending level (slot s is tree level
s + 1), with SENT = 65535 for absent or popped children.  The window's
state is stored as the kernel reads it (``window_layout``): ``tcodes``
lanes-first and contiguous, so one level of one lane is 64 adjacent
words for the lane's warp; every other field lane-minor (``lane_minor``:
field word w of lane i at w * n + i), read once per warp.
``walker_state_from_jax`` and
``walker_state_to_jax`` convert between this state and the JAX walker
state (transposed, biased int16 codes), in numpy.
"""
import ctypes

import numpy as np
import torch

from chroma_tpu_torch.bvh.mbvh import (
    ROW_WIDTH, HDR_KIND, HDR_BASE, BOX_OFF, QORIGIN_OFF, QSCALE_OFF,
    QVERT_OFF, QVERT_WORDS_PER_COMP, TRI_ID_OFF, MAT_OFF, BRANCH,
    IBOX_ORIGIN_OFF, IBOX_SCALE_OFF, XFORM_OFF, TRI_BASE_OFF, KIND_CLUSTER,
    KIND_LOCAL, KIND_ENTRY)

SENT = 65535
_EPS = 1e-6
_FLT_EPSILON = 1.1920929e-07
# the row layout csrc/mbvh_walk.cu is compiled for
KERNEL_BRANCH = 64
KERNEL_ROW_WIDTH = 424
KERNEL_MAX_DEPTH = 12     # MAX_SLOTS + 1 in csrc/mbvh_walk_core.cuh
# walker-state entries a closest-hit walk iteration never changes
_RAY_KEYS = ('org', 'dir', 'inv', 'noid', 'lht')
# the window kernel's state fields, in the order of enum Key in
# csrc/mbvh_walk_window.cu
KERNEL_STATE_KEYS = (
    'org', 'dir', 'inv', 'noid', 'lht', 'tcodes', 'bases', 'ptr', 'act',
    'lvl', 'tri', 'mat', 'min_dist', 'nrm', 'tbase', 'pad',
    'irot', 'iorg', 'idir', 'iinv', 'inoid',
    'od_org', 'od_dir', 'od_valid', 'od_lht',
    'park_dist', 'park_nrm', 'park_tri', 'park_mat',
    'od2_org', 'od2_dir', 'od2_valid', 'od2_lht',
    'park2_dist', 'park2_nrm', 'park2_tri', 'park2_mat')
_INST_KEYS = ('irot', 'iorg', 'idir', 'iinv', 'inoid')


class LaunchCounter:
    """Counts kernel launches, so a run can show which path it took."""

    def __init__(self):
        self.launches = 0

    def reset(self):
        self.launches = 0


closest_hit_launches = LaunchCounter()
# one counter per on-deck variant: K3 (od_slots 1) and K4 (od_slots 2)
walk_window_launches = {1: LaunchCounter(), 2: LaunchCounter()}


def nslots(depth):
    """Pending-level slots (level 0, the root, is never pending)."""
    return max(depth - 1, 1)


def check_kernel_layout(depth):
    """Raise unless the kernels are compiled for the tables' row layout
    and hold a tree of ``depth`` levels."""
    if BRANCH != KERNEL_BRANCH or ROW_WIDTH != KERNEL_ROW_WIDTH:
        raise ValueError('the walker kernel is compiled for BRANCH=%d, '
                         'ROW_WIDTH=%d; the tables use %d, %d'
                         % (KERNEL_BRANCH, KERNEL_ROW_WIDTH, BRANCH,
                            ROW_WIDTH))
    if not 1 <= depth <= KERNEL_MAX_DEPTH:
        raise ValueError('MBVH depth %d outside [1, %d]'
                         % (depth, KERNEL_MAX_DEPTH))


def _f32(x):
    return x.view(torch.float32)


def lane_minor(t):
    """``t`` (n, ...) copied into lane-minor storage: the same shape and
    values, with the lane index the fastest-moving in memory."""
    return t.movedim(0, -1).contiguous().movedim(-1, 0)


def is_lane_minor(t):
    return t.movedim(0, -1).is_contiguous()


# window-state fields stored lanes-first: one level of one lane is
# contiguous, as the warp that walks the lane reads it
LANES_FIRST_KEYS = ('tcodes',)


def in_window_layout(key, t):
    return t.is_contiguous() if key in LANES_FIRST_KEYS \
        else is_lane_minor(t)


def window_layout(W):
    """The window state ``W`` in the storage the window kernel reads:
    ``tcodes`` lanes-first (contiguous), every other field lane-minor
    (copied).  Shapes and values are unchanged."""
    return {k: v.contiguous() if k in LANES_FIRST_KEYS else lane_minor(v)
            for k, v in W.items()}


def state_fields(depth, instanced, od_slots):
    """{key: (dtype, per-lane shape)} of the on-deck window state."""
    S = nslots(depth)
    f32, i32 = torch.float32, torch.int32
    out = dict(org=(f32, (3,)), dir=(f32, (3,)), inv=(f32, (3,)),
               noid=(f32, (3,)), lht=(i32, ()), tcodes=(i32, (S, BRANCH)),
               bases=(i32, (S,)), ptr=(i32, ()), act=(torch.bool, ()),
               lvl=(i32, ()), tri=(i32, ()), mat=(i32, ()),
               min_dist=(f32, ()), nrm=(f32, (3,)), tbase=(i32, ()),
               pad=(i32, ()))
    if instanced:
        out.update(irot=(f32, (9,)), iorg=(f32, (3,)), idir=(f32, (3,)),
                   iinv=(f32, (3,)), inoid=(f32, (3,)))
    for slot in range(1, od_slots + 1):
        od, pk = ('od_', 'park_') if slot == 1 else ('od2_', 'park2_')
        out.update({od + 'org': (f32, (3,)), od + 'dir': (f32, (3,)),
                    od + 'valid': (torch.bool, ()), od + 'lht': (i32, ()),
                    pk + 'dist': (f32, ()), pk + 'nrm': (f32, (3,)),
                    pk + 'tri': (i32, ()), pk + 'mat': (i32, ())})
    return out


def _quant(t, sq):
    """Entry-distance code: floor(t*sq) clipped to [0, 65534]."""
    return torch.clamp(torch.floor(t * sq), 0.0, 65534.0)


def _slab(pk, bo, bs, inv, noid):
    """Slab test of quantized child boxes.  pk (m, 3, BRANCH) int32 box
    words (lo | hi << 16); bo, bs (m, 3, 1) or (3, 1) grid origin and
    scale; inv, noid (m, 3, 1).  Returns (tmin, tmax), each (m, BRANCH).
    Axes with infinite 1/dir are skipped."""
    lo = bo + (pk & 0xFFFF).float() * bs
    hi = bo + ((pk >> 16) & 0xFFFF).float() * bs
    return _slab_bounds(lo, hi, inv, noid)


def _slab_bounds(lo, hi, inv, noid):
    """Slab test of dequantized boxes lo, hi (.., 3, BRANCH)."""
    t0 = lo * inv + noid
    t1 = hi * inv + noid
    finite = torch.isfinite(inv)
    small = torch.where(finite, torch.minimum(t0, t1), -torch.inf)
    big = torch.where(finite, torch.maximum(t0, t1), torch.inf)
    tmin = torch.maximum(torch.maximum(small[:, 0], small[:, 1]),
                         small[:, 2])
    tmax = torch.minimum(torch.minimum(big[:, 0], big[:, 1]), big[:, 2])
    return torch.maximum(tmin, torch.zeros((), device=tmin.device)), tmax


def _cross3(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def seed(rows, depth, instanced, sq, org, dirv, lht, active):
    """Walker state with the root's children slab-tested and the nearest
    one popped (ties to the lowest slot)."""
    n = org.shape[0]
    dev = org.device
    S = nslots(depth)
    inv = 1.0 / dirv
    noid = -org * inv
    tcodes = torch.full((n, S, BRANCH), SENT, dtype=torch.int32, device=dev)
    bases = torch.zeros((n, S), dtype=torch.int32, device=dev)
    if depth < 2:
        ptr = torch.zeros(n, dtype=torch.int32, device=dev)
        act = active.clone()
        lvl = torch.zeros(n, dtype=torch.int32, device=dev)
    else:
        root = rows[0]
        rootf = _f32(root)
        slots = torch.arange(BRANCH, device=dev)
        pk = root[BOX_OFF:BOX_OFF + 3 * BRANCH].reshape(1, 3, BRANCH)
        bo = rootf[IBOX_ORIGIN_OFF:IBOX_ORIGIN_OFF + 3].reshape(3, 1)
        bs = rootf[IBOX_SCALE_OFF:IBOX_SCALE_OFF + 3].reshape(3, 1)
        tmin, tmax = _slab(pk, bo, bs, inv[:, :, None], noid[:, :, None])
        count = (root[HDR_KIND] >> 8) & 0xFFFFFF
        ok = (tmin <= tmax) & (slots < count) & active[:, None]
        codes = torch.where(ok, _quant(tmin, sq), float(SENT)).to(torch.int32)
        m = codes.min(dim=1, keepdim=True).values
        c = torch.where((codes == m) & ok, slots, BRANCH).min(dim=1).values
        act = ok.any(dim=1)
        codes = torch.where(slots == c[:, None], SENT, codes)
        tcodes[:, 0] = codes
        base = root[HDR_BASE]
        bases[:, 0] = base
        ptr = torch.where(act, base + c, 0).to(torch.int32)
        lvl = torch.ones(n, dtype=torch.int32, device=dev)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    W = dict(org=org, dir=dirv, inv=inv, noid=noid, lht=lht,
             tcodes=tcodes, bases=bases, ptr=ptr, act=act, lvl=lvl,
             tri=torch.full((n,), -1, dtype=torch.int32, device=dev),
             mat=zi, min_dist=torch.full((n,), torch.inf, device=dev),
             nrm=torch.zeros((n, 3), device=dev), tbase=zi.clone(),
             pad=zi.clone())
    if instanced:
        W.update(irot=torch.zeros((n, 9), device=dev),
                 iorg=torch.zeros((n, 3), device=dev),
                 idir=torch.ones((n, 3), device=dev),
                 iinv=torch.ones((n, 3), device=dev),
                 inoid=torch.zeros((n, 3), device=dev))
    return W


def walk_iter(row, W, depth, instanced, sq):
    """One walk iteration: process the row each active walk popped last,
    then pop its next row (inactive walks only pop).  ``row`` (m,
    ROW_WIDTH) int32, rows[ptr].  Returns the updated state dict."""
    dev = row.device
    m_ = row.shape[0]
    rowf = _f32(row)
    slots = torch.arange(BRANCH, device=dev)
    hdr = row[:, HDR_KIND]
    count = ((hdr >> 8) & 0xFFFFFF)[:, None]
    act_in = W['act']
    is_cluster = act_in & ((hdr & KIND_CLUSTER) != 0)
    is_internal = act_in & ((hdr & KIND_CLUSTER) == 0)
    lvl_cur = W['lvl']
    min_dist = W['min_dist']
    out = dict(W)

    e_org, e_dir, e_inv, e_noid = W['org'], W['dir'], W['inv'], W['noid']
    if instanced:
        # entry rows move the ray into the instance frame; LOCAL rows are
        # tested with the instance-frame ray
        ent = (act_in & ((hdr & KIND_ENTRY) != 0))[:, None]
        fl = ((hdr & KIND_LOCAL) != 0)[:, None]
        xf = rowf[:, XFORM_OFF:XFORM_OFF + 12]
        omt = W['org'] - xf[:, 9:12]
        d = W['dir']
        iorg_new = torch.stack(
            [xf[:, k] * omt[:, 0] + xf[:, 3 + k] * omt[:, 1]
             + xf[:, 6 + k] * omt[:, 2] for k in range(3)], dim=1)
        idir_new = torch.stack(
            [xf[:, k] * d[:, 0] + xf[:, 3 + k] * d[:, 1]
             + xf[:, 6 + k] * d[:, 2] for k in range(3)], dim=1)
        iinv_new = 1.0 / idir_new
        out['irot'] = irot = torch.where(ent, xf[:, 0:9], W['irot'])
        out['iorg'] = iorg = torch.where(ent, iorg_new, W['iorg'])
        out['idir'] = idir = torch.where(ent, idir_new, W['idir'])
        out['iinv'] = iinv = torch.where(ent, iinv_new, W['iinv'])
        out['inoid'] = inoid = torch.where(ent, -iorg_new * iinv_new,
                                           W['inoid'])
        out['tbase'] = tri_base = torch.where(
            ent[:, 0], row[:, TRI_BASE_OFF], W['tbase'])
        e_org = torch.where(fl, iorg, e_org)
        e_dir = torch.where(fl, idir, e_dir)
        e_inv = torch.where(fl, iinv, e_inv)
        e_noid = torch.where(fl, inoid, e_noid)

    # ---- cluster rows: Moller-Trumbore on all BRANCH triangles --------
    qorigin = rowf[:, QORIGIN_OFF:QORIGIN_OFF + 3]
    qscale = rowf[:, QSCALE_OFF:QSCALE_OFF + 3]
    # slot j's u16 is the low half of word j (j < 32) or the high half
    # of word j - 32
    w = row[:, QVERT_OFF:QVERT_OFF + 9 * QVERT_WORDS_PER_COMP].reshape(
        m_, 9, QVERT_WORDS_PER_COMP)
    q = torch.cat([w & 0xFFFF, (w >> 16) & 0xFFFF], dim=2).float()
    comp = [q[:, c] * qscale[:, c % 3, None] + qorigin[:, c % 3, None]
            for c in range(9)]
    v0, v1, v2 = comp[0:3], comp[3:6], comp[6:9]
    d3 = [e_dir[:, k:k + 1] for k in range(3)]
    o3 = [e_org[:, k:k + 1] for k in range(3)]
    e1 = [v1[k] - v0[k] for k in range(3)]
    e2 = [v2[k] - v0[k] for k in range(3)]
    h = _cross3(d3, e2)
    a = _dot3(e1, h)
    not_par = torch.abs(a) > _FLT_EPSILON
    f = 1.0 / torch.where(not_par, a, 1.0)
    sv = [o3[k] - v0[k] for k in range(3)]
    u_b = f * _dot3(sv, h)
    q3 = _cross3(sv, e1)
    v_b = f * _dot3(d3, q3)
    t_d = f * _dot3(e2, q3)
    t_hit = (not_par & (u_b >= -_EPS) & (u_b <= 1.0 + _EPS)
             & (v_b >= -_EPS) & (u_b + v_b <= 1.0 + _EPS) & (t_d > _EPS))
    tri_ids = row[:, TRI_ID_OFF:TRI_ID_OFF + BRANCH]
    if instanced:
        tri_ids = tri_ids + torch.where(fl, tri_base[:, None], 0)
    valid = t_hit & (slots < count) & (tri_ids != W['lht'][:, None])
    t_dist = torch.where(valid, t_d, torch.inf)
    cl_dist = t_dist.min(dim=1).values
    slot_min = torch.where(t_dist == cl_dist[:, None], slots,
                           BRANCH).min(dim=1).values.clamp(max=BRANCH - 1)
    improved = is_cluster & (cl_dist < min_dist)

    def pick(arr):
        return torch.gather(arr, 1, slot_min[:, None])[:, 0]

    # the TPU kernel picks by a one-hot sum, so -0.0 reads +0.0
    nl = [pick(x) + 0.0 for x in _cross3(e1, e2)]
    if instanced:
        nw = [irot[:, 3 * r] * nl[0] + irot[:, 3 * r + 1] * nl[1]
              + irot[:, 3 * r + 2] * nl[2] for r in range(3)]
        nl = [torch.where(fl[:, 0], nw[k], nl[k]) for k in range(3)]
    out['tri'] = torch.where(improved, pick(tri_ids), W['tri'])
    out['mat'] = torch.where(improved,
                             pick(row[:, MAT_OFF:MAT_OFF + BRANCH]),
                             W['mat'])
    out['nrm'] = torch.where(improved[:, None], torch.stack(nl, dim=1),
                             W['nrm'])
    out['min_dist'] = min_dist = torch.where(improved, cl_dist, min_dist)

    # ---- internal rows: slab-test the child boxes, push a level -------
    pk = row[:, BOX_OFF:BOX_OFF + 3 * BRANCH].reshape(m_, 3, BRANCH)
    bo = rowf[:, IBOX_ORIGIN_OFF:IBOX_ORIGIN_OFF + 3, None]
    bs = rowf[:, IBOX_SCALE_OFF:IBOX_SCALE_OFF + 3, None]
    tmin, tmax = _slab(pk, bo, bs, e_inv[:, :, None], e_noid[:, :, None])
    b_ok = (tmin <= tmax) & (tmin <= min_dist[:, None]) & (slots < count)
    newcodes = torch.where(b_ok, _quant(tmin, sq),
                           float(SENT)).to(torch.int32)
    push = (is_internal & (newcodes.min(dim=1).values < SENT)
            & (lvl_cur + 1 < depth))
    S = nslots(depth)
    sel = push[:, None] & (torch.arange(S, device=dev)
                           == lvl_cur[:, None])        # slot = level - 1
    tcodes = torch.where(sel[:, :, None], newcodes[:, None, :], W['tcodes'])
    bases = torch.where(sel, row[:, HDR_BASE, None], W['bases'])

    # ---- pop the nearest pending child of the deepest live level ------
    thresh = torch.clamp(torch.floor(min_dist * sq) + 1.0, 0.0,
                         65534.0).to(torch.int32)
    live = tcodes.min(dim=2).values <= thresh[:, None]          # (m, S)
    levels = torch.arange(1, S + 1, device=dev)
    lvl = torch.where(live, levels, -1).max(dim=1).values.to(torch.int32)
    act = lvl >= 0
    s_sel = torch.clamp(lvl - 1, min=0).long()
    tl = torch.gather(tcodes, 1, s_sel[:, None, None].expand(
        m_, 1, BRANCH))[:, 0]
    m = tl.min(dim=1, keepdim=True).values
    c = torch.where(tl == m, slots, BRANCH).min(dim=1).values
    popped = (act[:, None, None]
              & (levels[None, :, None] == lvl[:, None, None])
              & (slots[None, None, :] == c[:, None, None]))
    out['tcodes'] = torch.where(popped, SENT, tcodes)
    out['bases'] = bases
    base_sel = torch.gather(bases, 1, s_sel[:, None])[:, 0]
    out['ptr'] = torch.where(act, base_sel + c, 0).to(torch.int32)
    out['act'] = act
    out['lvl'] = lvl
    return out


def results(W):
    """The live walk registers as a closest-hit result; ``incomplete``
    marks walks still active."""
    return dict(triangle=W['tri'], distance=W['min_dist'], normal=W['nrm'],
                material_code=W['mat'], incomplete=W['act'])


def count_rows(work, rows, ptr):
    """Add the rows ``ptr`` that walks process to the tally ``work``:
    rows and child slots by kind, instance entries, and which rows were
    read.  The walks' results do not depend on it; chip_smoke.py counts
    a kernel's data-dependent work with it."""
    hdr = rows[ptr, HDR_KIND]
    cluster = (hdr & KIND_CLUSTER) != 0
    count = ((hdr >> 8) & 0xFFFFFF).long()
    for key, v in (('cluster_rows', cluster.sum()),
                   ('internal_rows', (~cluster).sum()),
                   ('cluster_slots', count[cluster].sum()),
                   ('internal_slots', count[~cluster].sum()),
                   ('entry_rows', ((hdr & KIND_ENTRY) != 0).sum())):
        work[key] = work.get(key, 0) + int(v)
    if 'visited' not in work:
        work['visited'] = torch.zeros(rows.shape[0], dtype=torch.bool,
                                      device=rows.device)
    work['visited'][ptr] = True


def closest_hit_plain(rows, org, dirv, lht, active, sq, depth, instanced,
                      max_iters, work=None):
    """Plain PyTorch walk (any device).  Same arguments and results as
    ``closest_hit_cuda``; ``work``, a dict, if given tallies the rows
    the walks processed (``count_rows``)."""
    W = seed(rows, depth, instanced, sq, org, dirv, lht, active)
    for _ in range(max_iters):
        idx = torch.nonzero(W['act']).squeeze(1)
        if idx.numel() == 0:
            break
        sub = {k: v[idx] for k, v in W.items()}
        ptr = sub['ptr'].long()
        if work is not None:
            count_rows(work, rows, ptr)
        sub = walk_iter(rows[ptr], sub, depth, instanced, sq)
        for k, v in sub.items():
            if k not in _RAY_KEYS:
                W[k].index_copy_(0, idx, v)
    return results(W)


def closest_hit_cuda(rows, org, dirv, lht, active, sq, depth, instanced,
                     max_iters):
    """Launch csrc/mbvh_walk.cu on CUDA tensors.  ``rows`` (R,
    ROW_WIDTH) int32; ``org``, ``dirv`` (n, 3) f32; ``lht`` (n,) int32;
    ``active`` (n,) bool; ``sq`` the entry-code scale as a float32
    value.  Returns dict(triangle, distance, normal, material_code,
    incomplete)."""
    from chroma_tpu_torch import _build
    check_kernel_layout(depth)
    n = org.shape[0]
    dev = org.device
    for name, t, dtype, shape in (
            ('rows', rows, torch.int32, (rows.shape[0], ROW_WIDTH)),
            ('origin', org, torch.float32, (n, 3)),
            ('direction', dirv, torch.float32, (n, 3)),
            ('last_hit_triangle', lht, torch.int32, (n,)),
            ('active', active, torch.bool, (n,))):
        if t.device != dev or dev.type != 'cuda':
            raise ValueError('%s must be a CUDA tensor on %s' % (name, dev))
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError('%s must be %s %s, got %s %s'
                             % (name, dtype, shape, t.dtype, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
    lib = _build.library()
    out = dict(triangle=torch.empty(n, dtype=torch.int32, device=dev),
               distance=torch.empty(n, dtype=torch.float32, device=dev),
               normal=torch.empty((n, 3), dtype=torch.float32, device=dev),
               material_code=torch.empty(n, dtype=torch.int32, device=dev),
               incomplete=torch.empty(n, dtype=torch.bool, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mbvh_closest_hit(
            rows.data_ptr(), org.data_ptr(), dirv.data_ptr(),
            lht.data_ptr(), active.data_ptr(), n, float(sq), int(depth),
            int(bool(instanced)), int(max_iters), out['triangle'].data_ptr(), out['distance'].data_ptr(),
            out['normal'].data_ptr(), out['material_code'].data_ptr(),
            out['incomplete'].data_ptr(), stream)
    if err != 0:
        raise RuntimeError('mbvh_closest_hit launch failed: cudaError %d'
                           % err)
    closest_hit_launches.launches += 1
    return out



# ---- the on-deck window (K3, K4) ---------------------------------------

def root_boxes_lohi(tables):
    """The root's children dequantized as the root seed computes them:
    (6 * BRANCH,) f32 [lo_x | hi_x | lo_y | hi_y | lo_z | hi_z]; zeros
    when the root is a single cluster row (depth < 2)."""
    rows = tables.mbvh_rows
    if int(tables.mbvh_depth) < 2:
        return torch.zeros(6 * BRANCH, device=rows.device)
    root = rows[0]
    rootf = _f32(root)
    parts = []
    for k in range(3):
        pk = root[BOX_OFF + k * BRANCH:BOX_OFF + (k + 1) * BRANCH]
        bo = rootf[IBOX_ORIGIN_OFF + k]
        bs = rootf[IBOX_SCALE_OFF + k]
        parts.append(bo + (pk & 0xFFFF).float() * bs)
        parts.append(bo + ((pk >> 16) & 0xFFFF).float() * bs)
    return torch.cat(parts)


def root_seed_args(tables):
    """(rbase, rcount, root_lohi) of the restart seed: the root row's
    HDR_BASE and child count as ints, and ``root_boxes_lohi``."""
    hdr = tables.mbvh_rows[0, :2].tolist()
    return int(hdr[HDR_BASE]), (int(hdr[HDR_KIND]) >> 8) & 0xFFFFFF, \
        root_boxes_lohi(tables)


def ondeck_empty(n, od_slots=1, device='cpu'):
    """Empty on-deck and park fields: no on-deck ray, nothing parked."""
    out = {}
    for k, (dtype, shape) in state_fields(1, False, od_slots).items():
        if k.startswith(('od', 'park')):
            out[k] = torch.zeros((n,) + shape, dtype=dtype, device=device)
    return out


def od_slot_seed(org, dirv, lht, valid, slot=1):
    """An on-deck slot: the ray, its last-hit triangle and a valid flag.
    The restarted walk's root pending set is seeded in the kernel."""
    pre = 'od_' if slot == 1 else 'od2_'
    return {pre + 'org': org, pre + 'dir': dirv, pre + 'lht': lht,
            pre + 'valid': valid}


def park_results(W, which='park'):
    """Results parked by a drain-restart swap, with ``parked`` the lanes
    that hold some (pad bit 1 for ``park``, 4 for ``park2``)."""
    bit = 1 if which == 'park' else 4
    return dict(triangle=W[which + '_tri'], distance=W[which + '_dist'],
                normal=W[which + '_nrm'], material_code=W[which + '_mat'],
                parked=(W['pad'] & bit) != 0)


def walk_iter_ondeck(row, W, depth, instanced, sq, od_slots, rbase, rcount,
                     root_lohi):
    """``walk_iter`` plus the drain-restart cascade of the TPU kernel's
    on-deck path (mbvh_pallas.py:405-513): a walk that drains this
    iteration parks its results (``park``, or ``park2`` once ``park`` is
    taken) and restarts on the slot's on-deck ray, root children seeded
    from ``root_lohi`` and the nearest popped.  ``rbase``/``rcount``:
    the root row's HDR_BASE and child count.  Returns the new state."""
    out = walk_iter(row, W, depth, instanced, sq)
    dev = row.device
    pad = W['pad']
    act = out['act']
    parked = (pad & 1) != 0
    done = ((pad & 2) != 0) | (W['act'] & ~act)
    swap1 = done & ~act & ~parked & W['od_valid']
    swap = swap1
    if od_slots == 2:
        parked2 = (pad & 4) != 0
        swap2 = done & ~act & parked & ~parked2 & W['od2_valid']
        swap = swap1 | swap2

    def park(pre, sw):
        out[pre + '_dist'] = torch.where(sw, out['min_dist'],
                                         W[pre + '_dist'])
        out[pre + '_nrm'] = torch.where(sw[:, None], out['nrm'],
                                        W[pre + '_nrm'])
        out[pre + '_tri'] = torch.where(sw, out['tri'], W[pre + '_tri'])
        out[pre + '_mat'] = torch.where(sw, out['mat'], W[pre + '_mat'])

    park('park', swap1)
    od_org, od_dir, od_lht = W['od_org'], W['od_dir'], W['od_lht']
    if od_slots == 2:
        park('park2', swap2)
        od_org = torch.where(swap2[:, None], W['od2_org'], od_org)
        od_dir = torch.where(swap2[:, None], W['od2_dir'], od_dir)
        od_lht = torch.where(swap2, W['od2_lht'], od_lht)
    od_inv = 1.0 / od_dir
    od_noid = -od_org * od_inv
    s1 = swap[:, None]
    for k, v in (('org', od_org), ('dir', od_dir), ('inv', od_inv),
                 ('noid', od_noid)):
        out[k] = torch.where(s1, v, out[k])
    out['min_dist'] = torch.where(swap, torch.inf, out['min_dist'])
    out['nrm'] = torch.where(s1, 0.0, out['nrm'])
    out['tri'] = torch.where(swap, -1, out['tri'])
    out['mat'] = torch.where(swap, 0, out['mat'])
    out['lht'] = torch.where(swap, od_lht, out['lht'])
    out['tbase'] = torch.where(swap, 0, out['tbase'])

    # restart seed: the root's children against the on-deck ray
    m_ = row.shape[0]
    slots = torch.arange(BRANCH, device=dev)
    if depth >= 2:
        lohi = root_lohi.reshape(3, 2, BRANCH)
        tmin, tmax = _slab_bounds(lohi[None, :, 0], lohi[None, :, 1],
                                  od_inv[:, :, None], od_noid[:, :, None])
        ok = (tmin <= tmax) & (slots < rcount)
        codes = torch.where(ok, _quant(tmin, sq),
                            float(SENT)).to(torch.int32)
        m = codes.min(dim=1, keepdim=True).values
        c = torch.where((codes == m) & ok, slots, BRANCH).min(dim=1).values
        s_act = ok.any(dim=1)
        seed_tc = torch.where(slots == c[:, None], SENT, codes)
        seed_ptr = torch.where(s_act, rbase + c, 0).to(torch.int32)
        seed_lvl = 1
    else:
        # the root is a single cluster row: pop it directly
        s_act = torch.ones(m_, dtype=torch.bool, device=dev)
        seed_tc = torch.full((m_, BRANCH), SENT, dtype=torch.int32,
                             device=dev)
        seed_ptr = torch.zeros(m_, dtype=torch.int32, device=dev)
        seed_lvl = 0
    out['ptr'] = torch.where(swap, seed_ptr, out['ptr'])
    out['act'] = torch.where(swap, s_act, act)
    out['lvl'] = torch.where(swap, seed_lvl, out['lvl']).to(torch.int32)
    tcodes = torch.where(swap[:, None, None], SENT, out['tcodes'])
    tcodes[:, 0] = torch.where(s1, seed_tc, out['tcodes'][:, 0])
    out['tcodes'] = tcodes
    bases = out['bases'].clone()
    bases[:, 0] = torch.where(swap, rbase, bases[:, 0])
    out['bases'] = bases
    bits = torch.where(parked | swap1, 1, 0) | torch.where(done & ~swap, 2, 0)
    if od_slots == 2:
        bits = bits | torch.where(parked2 | swap2, 4, 0)
    out['pad'] = bits.to(torch.int32)
    return out


def random_window_state(rows, depth, instanced, sq, n, od_slots,
                        rng_seed):
    """A seeded on-deck window state in ``window_layout``, for holding
    the window kernel against its plain version: walks from rays near
    the origin, ~10% of lanes inactive, an on-deck ray on ~2/3 of the
    lanes and (two slots) a second one on ~2/5 (only where the first is
    set)."""
    dev = rows.device
    rng = np.random.RandomState(rng_seed)

    def rays():
        o = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)

    org, dirv = rays()
    active = torch.from_numpy(rng.rand(n) > 0.1).to(dev)
    ondeck = []
    valid = rng.rand(n) < 0.67
    for slot in range(od_slots):
        ondeck.append(rays() + (torch.from_numpy(valid).to(dev),))
        valid = valid & (rng.rand(n) < 0.6)
    return window_state(rows, depth, instanced, sq, org, dirv, active,
                        ondeck)


def window_state(rows, depth, instanced, sq, org, dirv, active, ondeck):
    """An on-deck window state in ``window_layout``: walks seeded from
    rays ``org``, ``dirv`` (n, 3) where ``active``, and one on-deck slot
    for each (org, dir, valid) of ``ondeck``; no last-hit triangles."""
    n = org.shape[0]
    no_lht = torch.full((n,), -1, dtype=torch.int32, device=org.device)
    W = seed(rows, depth, instanced, sq, org, dirv, no_lht, active)
    W.update(ondeck_empty(n, len(ondeck), org.device))
    for slot, (o, d, valid) in enumerate(ondeck, 1):
        W.update(od_slot_seed(o, d, no_lht.clone(), valid, slot))
    return window_layout(W)


def _may_change(W, od_slots):
    """Lanes whose state an iteration can still change: walking, not
    yet popped empty, or drained with an on-deck ray due to swap in."""
    pad = W['pad']
    parked = (pad & 1) != 0
    due = ~parked & W['od_valid']
    if od_slots == 2:
        due = due | (parked & ((pad & 4) == 0) & W['od2_valid'])
    return W['act'] | (W['lvl'] >= 0) | (((pad & 2) != 0) & due)


def walk_window_plain(rows, W, n_iters, depth, instanced, sq, od_slots,
                      rbase, rcount, root_lohi, work=None):
    """``n_iters`` on-deck iterations over every lane of ``W``, in place
    (any device).  Same arguments as ``walk_window_cuda``; ``work``, a
    dict, if given tallies the rows processed (``count_rows``), the
    restart seeds (``seeds``) and the lanes that changed (``changed``)."""
    for _ in range(n_iters):
        idx = torch.nonzero(_may_change(W, od_slots)).squeeze(1)
        if idx.numel() == 0:
            break
        sub = {k: v[idx] for k, v in W.items()}
        new = walk_iter_ondeck(rows[sub['ptr'].long()], sub, depth,
                               instanced, sq, od_slots, rbase, rcount,
                               root_lohi)
        if work is not None:
            count_rows(work, rows, sub['ptr'][sub['act']].long())
            swapped = ((new['pad'] & ~sub['pad']) & 5) != 0
            work['seeds'] = work.get('seeds', 0) + int(swapped.sum())
            if 'changed' not in work:
                work['changed'] = torch.zeros_like(W['act'])
            work['changed'][idx] = True
        for k, v in new.items():
            if v is not sub[k]:
                W[k].index_copy_(0, idx, v)
    return W


def walk_window_cuda(rows, W, n_iters, depth, instanced, sq, od_slots,
                     rbase, rcount, root_lohi):
    """Launch csrc/mbvh_walk_window.cu on CUDA tensors: ``n_iters``
    on-deck iterations over every lane of ``W``, in place.  ``W`` holds
    the fields of ``state_fields(depth, instanced, od_slots)`` in
    ``window_layout``; ``rows`` (R, ROW_WIDTH) int32; ``root_lohi``
    (6 * BRANCH,) f32; ``sq`` the entry-code scale as a float32 value."""
    from chroma_tpu_torch import _build
    check_kernel_layout(depth)
    if od_slots not in (1, 2):
        raise ValueError('od_slots must be 1 or 2, got %r' % (od_slots,))
    dev = rows.device
    n = W['act'].shape[0]
    fields = state_fields(depth, instanced, od_slots)
    for name, t, dtype, shape in (
            ('rows', rows, torch.int32, (rows.shape[0], ROW_WIDTH)),
            ('root_lohi', root_lohi, torch.float32, (6 * BRANCH,))):
        if t.device != dev or dev.type != 'cuda':
            raise ValueError('%s must be a CUDA tensor on %s' % (name, dev))
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError('%s must be contiguous %s %s, got %s %s'
                             % (name, dtype, shape, t.dtype, tuple(t.shape)))
    ptrs = []
    for k in KERNEL_STATE_KEYS:
        if k not in fields:
            ptrs.append(None)
            continue
        t = W[k]
        dtype, shape = fields[k]
        if t.device != dev:
            raise ValueError('state %s must be a CUDA tensor on %s'
                             % (k, dev))
        if t.dtype != dtype or tuple(t.shape) != (n,) + shape:
            raise ValueError('state %s must be %s %s, got %s %s'
                             % (k, dtype, (n,) + shape, t.dtype,
                                tuple(t.shape)))
        if not in_window_layout(k, t):
            raise ValueError('state %s is not in the window layout '
                             '(window_layout())' % k)
        ptrs.append(t.data_ptr())
    lib = _build.library()
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mbvh_walk_window(
            rows.data_ptr(), arr, len(ptrs), n, float(sq), int(depth),
            int(bool(instanced)), int(od_slots), int(n_iters), int(rbase), int(rcount), root_lohi.data_ptr(), stream)
    if err != 0:
        raise RuntimeError('mbvh_walk_window launch failed: cudaError %d'
                           % err)
    walk_window_launches[od_slots].launches += 1
    return W


# ---- the JAX walker state, both ways (numpy only) ------------------------
# JAX layout (chroma_tpu/ops/mbvh_pallas.py): rays (12, n) f32 [org dir
# inv noid]; tcodes (S*BRANCH, n) int16 biased by -32768; bases (S, n)
# i32; uregs (8, n) u32 [ptr act lvl tri mat lht tbase pad]; hregs (4, n)
# [min_dist nrm]; iregs (24, n) [irot iorg idir iinv inoid 0 0 0];
# od*_rays (6, n) [org dir]; od*_uregs (2, n) u32 [valid lht]; park*
# (6, n) f32 [dist nrm tri mat] (tri and mat as bit patterns).
_BIAS = 32768


def walker_state_from_jax(Wj, depth, instanced, od_slots=0, device='cpu'):
    """JAX walker-state dict (numpy arrays; the on-deck keys when
    ``od_slots``) -> the port's lanes-first state in ``window_layout``.
    ``instanced`` decides whether the instance registers are kept."""
    S = nslots(depth)
    rays = np.asarray(Wj['rays'], np.float32)
    u = np.ascontiguousarray(np.asarray(Wj['uregs'])).view(np.int32)
    h = np.asarray(Wj['hregs'], np.float32)
    n = rays.shape[1]
    W = dict(org=rays[0:3].T, dir=rays[3:6].T, inv=rays[6:9].T,
             noid=rays[9:12].T, lht=u[5],
             tcodes=(np.asarray(Wj['tcodes']).astype(np.int32) + _BIAS)
             .reshape(S, BRANCH, n).transpose(2, 0, 1),
             bases=np.asarray(Wj['bases'], np.int32).T, ptr=u[0],
             act=u[1] != 0, lvl=u[2], tri=u[3], mat=u[4],
             min_dist=h[0], nrm=h[1:4].T, tbase=u[6], pad=u[7])
    if instanced:
        ir = np.asarray(Wj['iregs'], np.float32)
        W.update(irot=ir[0:9].T, iorg=ir[9:12].T, idir=ir[12:15].T,
                 iinv=ir[15:18].T, inoid=ir[18:21].T)
    for slot in range(1, od_slots + 1):
        od, pk = ('od_', 'park') if slot == 1 else ('od2_', 'park2')
        r = np.asarray(Wj[od + 'rays'], np.float32)
        ou = np.ascontiguousarray(np.asarray(Wj[od + 'uregs'])).view(
            np.int32)
        p = np.ascontiguousarray(np.asarray(Wj[pk], np.float32))
        W.update({od + 'org': r[0:3].T, od + 'dir': r[3:6].T,
                  od + 'valid': ou[0] != 0, od + 'lht': ou[1],
                  pk + '_dist': p[0], pk + '_nrm': p[1:4].T,
                  pk + '_tri': p[4].view(np.int32),
                  pk + '_mat': p[5].view(np.int32)})
    return window_layout({k: torch.from_numpy(np.array(v)).to(device)
                          for k, v in W.items()})


def walker_state_to_jax(W, depth, od_slots=0):
    """The port's walker state -> JAX walker-state dict of numpy arrays
    (the inverse of ``walker_state_from_jax``; a flat geometry's unused
    instance registers come back as zeros)."""
    S = nslots(depth)

    def a(k):
        return W[k].cpu().numpy().copy()   # never a view of the state

    def u32(k):
        return a(k).astype(np.int32).view(np.uint32)

    n = W['act'].shape[0]
    out = dict(
        rays=np.concatenate([a('org').T, a('dir').T, a('inv').T,
                             a('noid').T]).astype(np.float32),
        tcodes=(a('tcodes').transpose(1, 2, 0).reshape(S * BRANCH, n)
                - _BIAS).astype(np.int16),
        bases=np.ascontiguousarray(a('bases').T),
        uregs=np.stack([u32('ptr'), u32('act'), u32('lvl'), u32('tri'),
                        u32('mat'), u32('lht'), u32('tbase'), u32('pad')]),
        hregs=np.concatenate([a('min_dist')[None], a('nrm').T]),
        iregs=np.zeros((24, n), np.float32))
    if 'irot' in W:
        out['iregs'][0:21] = np.concatenate(
            [a(k).T for k in _INST_KEYS])
    for slot in range(1, od_slots + 1):
        od, pk = ('od_', 'park') if slot == 1 else ('od2_', 'park2')
        out[od + 'rays'] = np.concatenate(
            [a(od + 'org').T, a(od + 'dir').T]).astype(np.float32)
        out[od + 'uregs'] = np.stack([u32(od + 'valid'), u32(od + 'lht')])
        out[pk] = np.concatenate([
            a(pk + '_dist')[None], a(pk + '_nrm').T,
            a(pk + '_tri').view(np.float32)[None],
            a(pk + '_mat').view(np.float32)[None]])
    return out

"""The closest-hit MBVH walk: a CUDA kernel and its plain PyTorch version.

Counterpart of chroma_tpu/ops/mbvh_pallas.py.  Both versions compute
what ``intersect_mesh_pallas`` computes: ``seed`` (the root's children
slab-tested and the nearest one popped), ``walk_iter`` until no ray is
active, then ``results``.

* ``closest_hit_cuda`` launches csrc/mbvh_walk.cu: one thread per ray,
  each walk run to completion in one launch.
* ``closest_hit_plain`` is vectorized torch with the same pending-code
  semantics, one iteration per loop trip over the rays still walking
  (an inactive ray's state never changes, so stepping only the active
  ones is the same walk).  Every a*b+c rounds twice here, as in the
  kernel, which is built with --fmad=false: the two agree bit for bit.

State is lanes-first: ``tcodes`` (n, S, BRANCH) int32 holds the
unbiased 16-bit entry codes of each pending level (slot s is tree level
s + 1), with SENT = 65535 for absent or popped children.
"""
import torch

from chroma_tpu.bvh.mbvh import (ROW_WIDTH, HDR_KIND, HDR_BASE, BOX_OFF,
                                 QORIGIN_OFF, QSCALE_OFF, QVERT_OFF,
                                 QVERT_WORDS_PER_COMP, TRI_ID_OFF, MAT_OFF,
                                 BRANCH, IBOX_ORIGIN_OFF, IBOX_SCALE_OFF,
                                 XFORM_OFF, TRI_BASE_OFF, KIND_CLUSTER,
                                 KIND_LOCAL, KIND_ENTRY)

SENT = 65535
_EPS = 1e-6
_FLT_EPSILON = 1.1920929e-07
# the row layout csrc/mbvh_walk.cu is compiled for
KERNEL_BRANCH = 64
KERNEL_ROW_WIDTH = 424
KERNEL_MAX_DEPTH = 12     # MAX_SLOTS + 1 in csrc/mbvh_walk.cu
# walker-state entries a walk iteration never changes
_RAY_KEYS = ('org', 'dir', 'inv', 'noid', 'lht')


class LaunchCounter:
    """Counts kernel launches, so a run can show which path it took."""

    def __init__(self):
        self.launches = 0

    def reset(self):
        self.launches = 0


closest_hit_launches = LaunchCounter()


def nslots(depth):
    """Pending-level slots (level 0, the root, is never pending)."""
    return max(depth - 1, 1)


def _f32(x):
    return x.view(torch.float32)


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
    bases = torch.zeros((n, S), dtype=torch.int64, device=dev)
    if depth < 2:
        ptr = torch.zeros(n, dtype=torch.int64, device=dev)
        act = active.clone()
        lvl = torch.zeros(n, dtype=torch.int64, device=dev)
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
        base = root[HDR_BASE].to(torch.int64)
        bases[:, 0] = base
        ptr = torch.where(act, base + c, 0)
        lvl = torch.ones(n, dtype=torch.int64, device=dev)
    W = dict(org=org, dir=dirv, inv=inv, noid=noid, lht=lht,
             tcodes=tcodes, bases=bases, ptr=ptr, act=act, lvl=lvl,
             tri=torch.full((n,), -1, dtype=torch.int32, device=dev),
             mat=torch.zeros(n, dtype=torch.int32, device=dev),
             min_dist=torch.full((n,), torch.inf, device=dev),
             nrm=torch.zeros((n, 3), device=dev))
    if instanced:
        W.update(irot=torch.zeros((n, 9), device=dev),
                 iorg=torch.zeros((n, 3), device=dev),
                 idir=torch.ones((n, 3), device=dev),
                 iinv=torch.ones((n, 3), device=dev),
                 inoid=torch.zeros((n, 3), device=dev),
                 tbase=torch.zeros(n, dtype=torch.int32, device=dev))
    return W


def walk_iter(row, W, depth, instanced, sq):
    """One walk iteration for rays that are all active: process the row
    each popped last, then pop its next row.  ``row`` (m, ROW_WIDTH)
    int32.  Returns the updated state dict."""
    dev = row.device
    m_ = row.shape[0]
    rowf = _f32(row)
    slots = torch.arange(BRANCH, device=dev)
    hdr = row[:, HDR_KIND]
    count = ((hdr >> 8) & 0xFFFFFF)[:, None]
    is_cluster = (hdr & KIND_CLUSTER) != 0
    is_internal = ~is_cluster
    lvl_cur = W['lvl']
    min_dist = W['min_dist']
    out = dict(W)

    e_org, e_dir, e_inv, e_noid = W['org'], W['dir'], W['inv'], W['noid']
    if instanced:
        # entry rows move the ray into the instance frame; LOCAL rows are
        # tested with the instance-frame ray
        ent = ((hdr & KIND_ENTRY) != 0)[:, None]
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
    bases = torch.where(sel, row[:, HDR_BASE, None].to(torch.int64),
                        W['bases'])

    # ---- pop the nearest pending child of the deepest live level ------
    thresh = torch.clamp(torch.floor(min_dist * sq) + 1.0, 0.0,
                         65534.0).to(torch.int32)
    live = tcodes.min(dim=2).values <= thresh[:, None]          # (m, S)
    levels = torch.arange(1, S + 1, device=dev)
    lvl = torch.where(live, levels, -1).max(dim=1).values
    act = lvl >= 0
    s_sel = torch.clamp(lvl - 1, min=0)
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
    out['ptr'] = torch.where(act, base_sel + c, 0)
    out['act'] = act
    out['lvl'] = lvl
    return out


def _results(W):
    return dict(triangle=W['tri'], distance=W['min_dist'], normal=W['nrm'],
                material_code=W['mat'], incomplete=W['act'])


def closest_hit_plain(rows, org, dirv, lht, active, sq, depth, instanced,
                      max_iters):
    """Plain PyTorch walk (any device).  Same arguments and results as
    ``closest_hit_cuda``."""
    W = seed(rows, depth, instanced, sq, org, dirv, lht, active)
    for _ in range(max_iters):
        idx = torch.nonzero(W['act']).squeeze(1)
        if idx.numel() == 0:
            break
        sub = {k: v[idx] for k, v in W.items()}
        sub = walk_iter(rows[sub['ptr']], sub, depth, instanced, sq)
        for k, v in sub.items():
            if k not in _RAY_KEYS:
                W[k].index_copy_(0, idx, v)
    return _results(W)


def closest_hit_cuda(rows, org, dirv, lht, active, sq, depth, instanced,
                     max_iters):
    """Launch csrc/mbvh_walk.cu on CUDA tensors.  ``rows`` (R,
    ROW_WIDTH) int32; ``org``, ``dirv`` (n, 3) f32; ``lht`` (n,) int32;
    ``active`` (n,) bool; ``sq`` the entry-code scale as a float32
    value.  Returns dict(triangle, distance, normal, material_code,
    incomplete)."""
    from chroma_tpu_torch import _build
    if BRANCH != KERNEL_BRANCH or ROW_WIDTH != KERNEL_ROW_WIDTH:
        raise ValueError('the walker kernel is compiled for BRANCH=%d, '
                         'ROW_WIDTH=%d; the tables use %d, %d'
                         % (KERNEL_BRANCH, KERNEL_ROW_WIDTH, BRANCH,
                            ROW_WIDTH))
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
    if not 1 <= depth <= KERNEL_MAX_DEPTH:
        raise ValueError('MBVH depth %d outside [1, %d]'
                         % (depth, KERNEL_MAX_DEPTH))
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
            int(bool(instanced)), int(max_iters),
            out['triangle'].data_ptr(), out['distance'].data_ptr(),
            out['normal'].data_ptr(), out['material_code'].data_ptr(),
            out['incomplete'].data_ptr(), stream)
    if err != 0:
        raise RuntimeError('mbvh_closest_hit launch failed: cudaError %d'
                           % err)
    closest_hit_launches.launches += 1
    return out


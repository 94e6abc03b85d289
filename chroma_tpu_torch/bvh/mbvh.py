"""Wide (multi-branching) BVH: the packed fat-row tables both walker
kernels read.

A copy of chroma_tpu/bvh/mbvh.py.  The row layout, its constants
(``LAYOUT_VERSION``, ``BRANCH``, ``ROW_WIDTH``, the row offsets) and the
build are kept at the JAX package's values, so both packages build the
same rows bit for bit and read each other's packed-table cache.  The
tree packs into self-contained rows of one uniform width:

  * an *internal row* holds up to BRANCH quantized child AABBs plus
    the global id of the first child row (children are consecutive),
    and carries its own box dequantization constants (origin + scale)
    so different subtrees can use different fixed-point grids;
  * a *cluster row* holds up to BRANCH fully-assembled triangles
    (vertices, triangle ids, material codes) ready for direct
    Moller-Trumbore testing — leaf AABBs are skipped entirely;
  * an *instance-entry row* is an internal row that also carries a
    rigid transform: popping it moves the ray into the instance's local
    frame and its children are the shared BLAS's root children.  One
    BLAS is built per unique (mesh, material codes) solid and shared by
    every placement, so the 10k-identical-PMT demo stores ~4k unique
    triangles instead of ~42M.

At BRANCH=64 the 42M-triangle instanced full demo is 6 levels deep.
BRANCH and TARGET_DEGREE are env-overridable (CHROMA_TPU_BRANCH /
CHROMA_TPU_TARGET_DEGREE) for build experiments; the CUDA walkers are
compiled for BRANCH=64 and refuse other tables.  Construction is the
binned-SAH wide build of csrc/host_native.cc, with the Morton
recursive-grid coarsening of the reference builder (chroma/bvh/grid.py)
as the no-toolchain fallback.  Traversal semantics follow
chroma/cuda/mesh.h:41.
"""
import os
from hashlib import md5 as _md5

import numpy as np

from chroma_tpu_torch.bvh.build import _intra_run

BRANCH = int(os.environ.get('CHROMA_TPU_BRANCH', 64))
                               # children per block / triangles per cluster
TARGET_DEGREE = int(os.environ.get('CHROMA_TPU_TARGET_DEGREE',
                                   BRANCH * 3 // 4))
                               # Morton coarsening mean fan-out target

# row layout (u32 words).  Cluster triangle vertices are quantized to
# u16 on a per-cluster local grid (origin + per-axis scale).
HDR_KIND = 0                   # bit0: 1=cluster; bit1: 1=row content is
                               # in a BLAS local frame; bit2: 1=instance
                               # entry (carries a transform);
                               # bits 8..15: child count
KIND_CLUSTER = 1
KIND_LOCAL = 2
KIND_ENTRY = 4
HDR_BASE = 1                   # internal: global row id of first child
BOX_OFF = 2                    # internal: component-major, axis k's
                               # BRANCH lo|hi<<16 words at BOX_OFF+k*BRANCH
QORIGIN_OFF = 2                # cluster: 3 x f32 local origin
QSCALE_OFF = 5                 # cluster: 3 x f32 local scale
QVERT_OFF = 8                  # cluster: 9 components x BRANCH u16,
QVERT_WORDS_PER_COMP = BRANCH // 2          # component-major u16 pairs
TRI_ID_OFF = QVERT_OFF + 9 * QVERT_WORDS_PER_COMP  # BRANCH tri ids
MAT_OFF = TRI_ID_OFF + BRANCH               # BRANCH mat codes
ROW_WIDTH = MAT_OFF + BRANCH                # 424 words = 1696 B at BRANCH=64
# internal/entry rows use the words after the box region (free in the
# cluster-dominated ROW_WIDTH) for their own decode constants:
IBOX_ORIGIN_OFF = BOX_OFF + 3 * BRANCH      # 3 x f32 box grid origin
IBOX_SCALE_OFF = IBOX_ORIGIN_OFF + 3        # 3 x f32 box grid scale
XFORM_OFF = IBOX_SCALE_OFF + 3              # entry: 9 x f32 R (row-major,
                                            # local->world) + 3 x f32 T
TRI_BASE_OFF = XFORM_OFF + 12               # entry: global tri id offset
assert TRI_BASE_OFF + 1 <= ROW_WIDTH
LAYOUT_VERSION = 7
# tree-construction algorithm: 'sah' (binned-SAH binary build + wide
# collapse, C++ csrc/host_native.cc sah_wide_build) or 'grid'
# (Morton recursive-grid coarsening).  SAH minimizes child overlap so
# rays descend into fewer subtrees (fewer row fetches per photon
# step); grid remains as the no-toolchain fallback.
USE_SAH = os.environ.get('CHROMA_TPU_SAH', '1') != '0'


def builder_tag():
    """Cache-key tag naming the tree builder actually in use."""
    from chroma_tpu_torch import native
    if USE_SAH and native.native() is not None:
        return 'sah1'
    return 'grid'


# the row halfword layout pairs slot j with slot j + BRANCH/2, in whole
# 32-bit words (CHROMA_TPU_BRANCH is env-overridable)
assert BRANCH >= 32 and BRANCH % 32 == 0, \
    'CHROMA_TPU_BRANCH must be a positive multiple of 32'


class MBVH(object):
    """Packed wide BVH: uniform (R, ROW_WIDTH) u32 rows, root row 0."""

    def __init__(self, world_coords, rows, nblocks, depth, ntriangles,
                 instanced=False):
        self.world_coords = world_coords
        self.rows = rows
        self.nblocks = nblocks
        self.depth = depth
        self.ntriangles = ntriangles
        self.instanced = instanced

    def __len__(self):
        return len(self.rows)


def _coarsen_group(morton_codes, nnodes, target_degree, branch=None):
    """One recursive-grid grouping round: coarsen codes until the mean
    fan-out reaches target_degree, then split runs > ``branch``
    (default BRANCH).  Returns (first_child, nchild, coarsened_codes)."""
    if branch is None:
        branch = BRANCH
    codes = morton_codes
    nunique = int((np.ediff1d(codes) > 0).sum()) + 1
    while nnodes / float(max(nunique, 1)) < target_degree and nunique > 1:
        codes = codes >> np.uint64(1)
        nunique = int((np.ediff1d(codes) > 0).sum()) + 1

    first_child = np.flatnonzero(
        np.ediff1d(codes, to_begin=np.uint64(1)) > 0).astype(np.int64)
    run_len = np.ediff1d(first_child, to_end=nnodes - first_child[-1])
    nsplit = -(-run_len // branch)
    if (nsplit > 1).any():
        starts = np.repeat(first_child, nsplit)
        intra = _intra_run(nsplit)
        first_child = (starts + intra * branch).astype(np.int64)
    nchild = np.ediff1d(first_child,
                        to_end=nnodes - first_child[-1]).astype(np.int64)
    return first_child, nchild, codes


def _leaf_data(mesh):
    """(world_coords, lo (T,3) u32, hi (T,3) u32, morton (T,) u64),
    preferring the native C++ helper (csrc/chroma_native.cc)."""
    from chroma_tpu_torch.bvh.bvh import WorldCoords
    from chroma_tpu_torch import native

    vertices = mesh.vertices
    world_origin = vertices.min(axis=0)
    world_scale = float(np.max(vertices.max(axis=0) - world_origin)
                        / (2 ** 16 - 2))
    world_scale = max(world_scale, 1e-12)
    wc = WorldCoords(world_origin=world_origin, world_scale=world_scale)

    nat = native.quantize_and_morton(vertices, mesh.triangles,
                                     world_origin, world_scale)
    if nat is not None:
        lo, hi, morton = nat
        return wc, lo, hi, morton

    # numpy fallback (same math as create_leaf_nodes, unpacked)
    tv = vertices[mesh.triangles]
    lower = tv.min(axis=1)
    upper = tv.max(axis=1)
    centroid = tv.mean(axis=1)

    def quantize(v):
        return ((v - world_origin) / world_scale).astype(np.uint32)

    lo = quantize(lower)
    lo[lo > 0] -= 1
    hi = quantize(upper) + 1
    from chroma_tpu_torch.bvh.build import morton_codes_3d
    morton = morton_codes_3d(quantize(centroid))
    return wc, lo, hi, morton


def _grouping_rounds(cur_lo, cur_hi, codes, nleaves, target_degree):
    """Bottom-up recursive-grid grouping over Morton-sorted leaf boxes.

    Returns (groupings, layer_lo, layer_hi): groupings[k] is the
    (first_child, nchild) run structure grouping layer k-1 nodes
    (layer -1 = the leaves) into layer k nodes; layer_lo/hi[k] are the
    grid-coordinate AABBs of layer k's nodes."""
    from chroma_tpu_torch import native

    groupings = []
    layer_lo, layer_hi = [], []
    n = nleaves
    while n > 1:
        nat = native.coarsen_group(codes, target_degree, BRANCH)
        if nat is not None:
            first_child, codes_used = nat
            nchild = np.ediff1d(first_child,
                                to_end=n - first_child[-1]).astype(np.int64)
        else:
            first_child, nchild, codes_used = _coarsen_group(
                codes, n, target_degree)
        groupings.append((first_child, nchild))
        seg = native.segment_min_max(cur_lo, cur_hi, first_child, nchild)
        if seg is not None:
            cur_lo, cur_hi = seg
        else:
            cur_lo = np.minimum.reduceat(cur_lo, first_child, axis=0)
            cur_hi = np.maximum.reduceat(cur_hi, first_child, axis=0)
        layer_lo.append(cur_lo)
        layer_hi.append(cur_hi)
        codes = codes_used[first_child]
        n = len(first_child)
    if not groupings:
        groupings.append((np.array([0], dtype=np.int64),
                          np.array([nleaves], dtype=np.int64)))
        layer_lo.append(cur_lo[:1])
        layer_hi.append(cur_hi[:1])
    return groupings, layer_lo, layer_hi


def _write_f32(rows, dst, off, values):
    """Store float32 ``values`` (k,3)-or-(3,) into u32 words at
    ``off..off+3`` of rows ``dst``."""
    v = np.ascontiguousarray(np.broadcast_to(
        np.asarray(values, dtype=np.float32),
        (len(np.atleast_1d(dst)), 3)))
    rows[np.atleast_1d(dst)[:, None], off + np.arange(3)[None, :]] = \
        v.view(np.uint32)


def _emit_cluster_rows(rows, cdst, fc0, nc0, tv_all, tri_order,
                       material_codes, frame_local, tri_id_offset=0):
    """Fill cluster rows ``cdst`` from leaf grouping (fc0, nc0)."""
    nclusters = len(fc0)
    kind = np.uint32(KIND_CLUSTER | (KIND_LOCAL if frame_local else 0))
    rows[cdst, HDR_KIND] = kind | (nc0.astype(np.uint32) << 8)
    slot = _intra_run(nc0)
    leaf_idx = np.repeat(fc0, nc0) + slot
    tri_ids = tri_order[leaf_idx]
    crow = np.arange(nclusters)
    dst_row = cdst[np.repeat(crow, nc0)]
    verts = tv_all[tri_ids]                              # (T,3,3)

    # per-cluster local grid
    cl_min = np.minimum.reduceat(verts.min(axis=1), fc0, axis=0)
    cl_max = np.maximum.reduceat(verts.max(axis=1), fc0, axis=0)
    scale = np.maximum((cl_max - cl_min) / 65535.0, 1e-12) \
        .astype(np.float32)
    origin = cl_min.astype(np.float32)
    rows[cdst[:, None], QORIGIN_OFF + np.arange(3)[None, :]] = \
        origin.view(np.uint32)
    rows[cdst[:, None], QSCALE_OFF + np.arange(3)[None, :]] = \
        scale.view(np.uint32)

    crep = np.repeat(crow, nc0)
    q = np.clip(np.round(
        (verts - origin[crep][:, None, :]) / scale[crep][:, None, :]),
        0, 65535).astype(np.uint32)                      # (T,3,3)
    padded = np.zeros((nclusters, BRANCH, 9), dtype=np.uint32)
    padded[crep, slot, :] = q.reshape(-1, 9)
    # block halfword layout: word w holds slots (w, w + BRANCH/2) so
    # the walker unpacks with a concat instead of a lane interleave
    half = BRANCH // 2
    packed = padded[:, :half, :] | (padded[:, half:, :] << 16)
    rows[cdst[:, None],
         QVERT_OFF + np.arange(9 * QVERT_WORDS_PER_COMP)[None, :]] = \
        packed.transpose(0, 2, 1).reshape(nclusters, -1)

    rows[dst_row, TRI_ID_OFF + slot] = \
        (tri_ids + tri_id_offset).astype(np.uint32)
    rows[dst_row, MAT_OFF + slot] = material_codes[tri_ids]


def _emit_internal_rows(rows, dst, fc, nc, child_base, child_lo, child_hi,
                        box_origin, box_scale, frame_local):
    """Fill internal rows ``dst``: children at child_base + fc .. and
    child AABBs (child_lo/hi u32 grid coords) in the box region, with
    the row-carried dequant constants (box_origin, box_scale)."""
    nk = len(fc)
    prow = np.arange(nk)
    kind = np.uint32(KIND_LOCAL if frame_local else 0)
    rows[dst, HDR_KIND] = kind | (nc.astype(np.uint32) << 8)
    rows[dst, HDR_BASE] = (child_base + fc).astype(np.uint32)
    slot = _intra_run(nc)
    child = np.repeat(fc, nc) + slot
    dst_rep = dst[np.repeat(prow, nc)]
    lo = child_lo[child]
    hi = child_hi[child]
    for ax in range(3):
        rows[dst_rep, BOX_OFF + ax * BRANCH + slot] = \
            lo[:, ax] | (hi[:, ax] << 16)
    # empty slots: invalid box (lo=0xFFFF > hi=0) never hits
    empty = np.ones((nk, BRANCH), dtype=bool)
    empty[np.repeat(prow, nc), slot] = False
    erow, eslot = np.nonzero(empty)
    for ax in range(3):
        rows[dst[erow], BOX_OFF + ax * BRANCH + eslot] = 0xFFFF
    _write_f32(rows, dst, IBOX_ORIGIN_OFF, box_origin)
    _write_f32(rows, dst, IBOX_SCALE_OFF, box_scale)


def _quantize_boxes(lo, hi, world_origin, world_scale):
    """Conservative 16-bit grid quantization of float AABBs, matching
    the _leaf_data convention (floor-1 / +1 widening)."""
    inv = 1.0 / world_scale
    qlo = np.clip((lo - world_origin) * inv, 0, 2 ** 16 - 2) \
        .astype(np.uint32)
    qlo[qlo > 0] -= 1
    qhi = np.clip((hi - world_origin) * inv, 0, 2 ** 16 - 2) \
        .astype(np.uint32) + 1
    return qlo, qhi


def _build_rows_sah(mesh, material_codes, frame_local=False,
                    tri_id_offset=0):
    """SAH variant of _build_rows (same contract), or None when the
    native builder is unavailable."""
    from chroma_tpu_torch import native
    from chroma_tpu_torch.bvh.bvh import WorldCoords

    tv_all = mesh.vertices[mesh.triangles].astype(np.float32)  # (T,3,3)
    ntris = len(mesh.triangles)
    if material_codes is None:
        material_codes = np.zeros(ntris, dtype=np.uint32)
    material_codes = np.asarray(material_codes, dtype=np.uint32)

    lower = tv_all.min(axis=1)
    upper = tv_all.max(axis=1)
    b = native.sah_wide_build(lower, upper, BRANCH, BRANCH)
    if b is None:
        return None
    if b['depth'] > 12:      # ops.mbvh.MAX_LEVELS: deeper levels are
        return None          # unreachable — fall back to grid build

    vertices = mesh.vertices
    world_origin = vertices.min(axis=0)
    world_scale = float(np.max(vertices.max(axis=0) - world_origin)
                        / (2 ** 16 - 2))
    world_scale = max(world_scale, 1e-12)
    wc = WorldCoords(world_origin=world_origin, world_scale=world_scale)

    W = len(b['kind'])
    rows = np.zeros((W, ROW_WIDTH), dtype=np.uint32)
    row_lo, row_hi = _quantize_boxes(b['node_lo'], b['node_hi'],
                                     world_origin, world_scale)

    clus = b['kind'] == 1
    cdst = np.flatnonzero(clus).astype(np.int64)
    if len(cdst):
        _emit_cluster_rows(rows, cdst, b['child_start'][clus],
                           b['child_count'][clus], tv_all,
                           b['leaf_order'], material_codes, frame_local,
                           tri_id_offset)
    idst = np.flatnonzero(~clus).astype(np.int64)
    if len(idst):
        _emit_internal_rows(rows, idst, b['child_start'][~clus],
                            b['child_count'][~clus], 0, row_lo, row_hi,
                            world_origin, np.repeat(world_scale, 3),
                            frame_local)
    return dict(wc=wc, rows=rows, nlayers=b['depth'],
                nblocks=int(len(idst)), ntris=ntris, row_lo=row_lo,
                row_hi=row_hi)


def _build_rows(mesh, material_codes, target_degree, frame_local=False,
                tri_id_offset=0):
    """Build the packed row block for one mesh (root at row 0).

    Returns a dict: wc (grid WorldCoords), rows, nlayers, ntris,
    row_lo/row_hi ((R,3) u32 per-row AABBs in grid coords).  Cluster
    triangle ids are ``tri_id_offset`` + local index (instance entries
    instead carry the offset at traversal time, so BLAS blocks pass 0).

    Uses the binned-SAH wide build (csrc sah_wide_build) when the
    native library is present and USE_SAH; otherwise the Morton
    recursive-grid grouping below.
    """
    if USE_SAH:
        built = _build_rows_sah(mesh, material_codes,
                                frame_local=frame_local,
                                tri_id_offset=tri_id_offset)
        if built is not None:
            return built
    tv_all = mesh.vertices[mesh.triangles].astype(np.float32)  # (T,3,3)
    ntris = len(mesh.triangles)
    if material_codes is None:
        material_codes = np.zeros(ntris, dtype=np.uint32)
    material_codes = np.asarray(material_codes, dtype=np.uint32)

    world_coords, cur_lo, cur_hi, morton = _leaf_data(mesh)
    from chroma_tpu_torch import native
    order = native.radix_argsort_u64(morton)
    if order is None:
        order = np.argsort(morton, kind='stable')
    morton = morton[order]
    tri_order = order.astype(np.int64)           # leaf i -> triangle id
    cur_lo = cur_lo[order]
    cur_hi = cur_hi[order]

    groupings, layer_lo, layer_hi = _grouping_rounds(
        cur_lo, cur_hi, morton, ntris, target_degree)

    # layers, bottom-up: layer 0 = clusters, layer k>0 = internal.
    nlayers = len(groupings)
    layer_sizes = [len(g[0]) for g in groupings]

    # global row ids: internal rows top-down layer by layer, clusters
    # last — root is always row 0.
    nclusters = layer_sizes[0]
    nblocks = sum(layer_sizes[1:]) if nlayers > 1 else 0
    id_base = {}
    running = 0
    for k in range(nlayers - 1, 0, -1):
        id_base[k] = running
        running += layer_sizes[k]
    id_base[0] = running
    assert running == nblocks

    rows = np.zeros((nblocks + nclusters, ROW_WIDTH), dtype=np.uint32)
    row_lo = np.zeros((nblocks + nclusters, 3), dtype=np.uint32)
    row_hi = np.zeros((nblocks + nclusters, 3), dtype=np.uint32)

    fc0, nc0 = groupings[0]
    cdst = id_base[0] + np.arange(nclusters)
    _emit_cluster_rows(rows, cdst, fc0, nc0, tv_all, tri_order,
                       material_codes, frame_local, tri_id_offset)
    row_lo[cdst] = layer_lo[0]
    row_hi[cdst] = layer_hi[0]

    for k in range(1, nlayers):
        fc, nc = groupings[k]
        dst = id_base[k] + np.arange(len(fc))
        _emit_internal_rows(rows, dst, fc, nc, id_base[k - 1],
                            layer_lo[k - 1], layer_hi[k - 1],
                            world_coords.world_origin,
                            np.repeat(world_coords.world_scale, 3),
                            frame_local)
        row_lo[dst] = layer_lo[k]
        row_hi[dst] = layer_hi[k]

    return dict(wc=world_coords, rows=rows, nlayers=nlayers,
                nblocks=nblocks, ntris=ntris, row_lo=row_lo,
                row_hi=row_hi)


def build_mbvh(mesh, material_codes=None, target_degree=TARGET_DEGREE):
    """Build a (non-instanced) MBVH over ``mesh``.

    ``material_codes``: optional (T,) uint32 per-triangle packed
    material/surface codes baked into cluster rows (zeros if omitted).
    """
    b = _build_rows(mesh, material_codes, target_degree)
    return MBVH(b['wc'], b['rows'], b['nblocks'], b['nlayers'],
                b['ntris'])


def _orthonormal(rot):
    """True if ``rot`` is a proper rotation (instancing requires a
    rigid transform so ray-space distances equal world distances)."""
    return (np.allclose(rot @ rot.T, np.eye(3), atol=1e-5)
            and np.linalg.det(rot) > 0.0)


def _classify_placements(geometry, material_codes):
    """Split the placements of ``geometry`` into instanced groups and
    inline placements.

    A group of >= 2 rigid placements sharing one (mesh, material
    codes) solid is worth a shared BLAS + per-placement entry rows.
    Everything else (single placements like the detector envelope,
    or non-rigid transforms) is built inline in WORLD frame: its
    subtrees join the TLAS directly with tight per-subtree AABBs, so
    the walker never commits to a whole-envelope entry whose AABB
    contains every other solid.

    Returns (inst_groups, inline_ids, nt): inst_groups is a list of
    (mesh, codes, placement-id array); inline_ids the remaining
    placement ids; nt the per-placement global triangle-id offsets.
    """
    solids = geometry.solids
    tri_counts = np.array([len(s.mesh.triangles) for s in solids],
                          dtype=np.int64)
    nt = np.concatenate([[0], np.cumsum(tri_counts)]).astype(np.int64)
    rot = np.asarray(geometry.solid_rotations, dtype=np.float64)

    groups, order = {}, []
    for i, s in enumerate(solids):
        if tri_counts[i] == 0:
            continue
        codes = material_codes[nt[i]:nt[i + 1]]
        key = (id(s.mesh),
               _md5(np.ascontiguousarray(codes)).hexdigest())
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(i)

    inst_groups, inline_ids = [], []
    for key in order:
        plist = groups[key]
        rigid = all(_orthonormal(rot[i]) for i in plist)
        if len(plist) >= 2 and rigid:
            i0 = plist[0]
            inst_groups.append((solids[i0].mesh,
                                material_codes[nt[i0]:nt[i0 + 1]],
                                np.array(plist, dtype=np.int64)))
        else:
            inline_ids.extend(plist)
    return inst_groups, inline_ids, nt


def instancing_gain(geometry):
    """Triangles saved by instancing: sum over placement groups of
    (copies - 1) x triangles."""
    seen = {}
    gain = 0
    for s in geometry.solids:
        k = id(s.mesh)
        if k in seen:
            gain += len(s.mesh.triangles)
        else:
            seen[k] = True
    return gain


# inline-block subtree patch expansion: descend from the block root
# until at least PATCH_MIN tight subtrees join the TLAS (stop early if
# the next level would exceed PATCH_MAX candidates).  Patches break
# the whole-envelope AABB (which contains every other solid and would
# otherwise always be popped first at entry distance ~0) into chunks
# with honest entry distances.
PATCH_MIN = 192
PATCH_MAX = 8192


def _expand_patches(blk):
    """(row ids local to ``blk``, levels-below-leaf per id array)."""
    rows = blk['rows']
    ids = np.array([0], dtype=np.int64)
    below = np.array([max(blk['nlayers'] - 1, 0)], dtype=np.int64)
    while len(ids) < PATCH_MIN:
        is_int = (rows[ids, HDR_KIND] & KIND_CLUSTER) == 0
        if not is_int.any():
            break
        base = rows[ids, HDR_BASE].astype(np.int64)
        cnt = (rows[ids, HDR_KIND] >> 8).astype(np.int64)
        cnt = np.where(is_int, cnt, 1)
        if cnt.sum() > PATCH_MAX:
            break
        nxt_ids = np.empty(cnt.sum(), dtype=np.int64)
        nxt_below = np.empty(cnt.sum(), dtype=np.int64)
        off = np.concatenate([[0], np.cumsum(cnt)])
        for j in range(len(ids)):
            if is_int[j]:
                nxt_ids[off[j]:off[j + 1]] = \
                    base[j] + np.arange(cnt[j])
                nxt_below[off[j]:off[j + 1]] = below[j] - 1
            else:
                nxt_ids[off[j]] = ids[j]
                nxt_below[off[j]] = below[j]
        ids, below = nxt_ids, nxt_below
    return ids, below


def build_mbvh_instanced(geometry, material_codes,
                         target_degree=TARGET_DEGREE):
    """Build a two-level MBVH for ``geometry`` (a flattened
    Geometry/Detector): a TLAS whose leaf level mixes

      * instance-entry rows — one per placement of a multi-placement
        rigid solid, all sharing that solid's BLAS block (built once
        in the solid's local frame, rays transformed at entry pop);
      * world-frame subtree patches of every remaining placement
        (single placements and non-rigid transforms), built inline
        with global triangle ids — see _expand_patches.

    Returns None when nothing is instanceable (no multi-placement
    rigid group); callers fall back to the flat build, which is
    equivalent in that case.
    """
    from types import SimpleNamespace
    from chroma_tpu_torch.bvh.bvh import WorldCoords
    from chroma_tpu_torch.bvh.build import morton_codes_3d
    from chroma_tpu_torch import native

    material_codes = np.asarray(material_codes, dtype=np.uint32)
    inst_groups, inline_ids, nt = _classify_placements(
        geometry, material_codes)
    if not inst_groups:
        return None
    rot_all = np.asarray(geometry.solid_rotations, dtype=np.float64)
    disp_all = np.asarray(geometry.solid_displacements,
                          dtype=np.float64)

    # ---- shared BLAS per instanced group (local frame, local tri
    # ids: the entry row carries the per-placement global base) ------
    blas = []
    for mesh, codes, plist in inst_groups:
        b = _build_rows(mesh, codes, target_degree, frame_local=True)
        b['bounds'] = (mesh.vertices.min(axis=0),
                       mesh.vertices.max(axis=0))
        blas.append(b)

    # ---- world-frame inline block per remaining placement ----------
    inline = []
    for i in inline_ids:
        s = geometry.solids[i]
        wv = s.mesh.vertices @ rot_all[i].T + disp_all[i]
        wmesh = SimpleNamespace(vertices=wv.astype(np.float32),
                                triangles=s.mesh.triangles)
        b = _build_rows(wmesh, material_codes[nt[i]:nt[i + 1]],
                        target_degree, tri_id_offset=int(nt[i]))
        b['patch_ids'], b['patch_below'] = _expand_patches(b)
        inline.append(b)

    # ---- leaf-level candidates: (world AABB, content source) -------
    ninst = int(sum(len(p) for _, _, p in inst_groups))
    npatch = int(sum(len(b['patch_ids']) for b in inline))
    ncand = ninst + npatch
    if ncand < 2:
        return None
    wlo = np.empty((ncand, 3), dtype=np.float64)
    whi = np.empty((ncand, 3), dtype=np.float64)

    # entries first (group-major), then patches (block-major)
    ent_group = np.empty(ninst, dtype=np.int64)   # candidate -> group
    ent_place = np.empty(ninst, dtype=np.int64)   # candidate -> placement
    pos = 0
    for k, (mesh, codes, plist) in enumerate(inst_groups):
        sel = slice(pos, pos + len(plist))
        lo, hi = blas[k]['bounds']
        corners = np.stack(np.meshgrid([lo[0], hi[0]], [lo[1], hi[1]],
                                       [lo[2], hi[2]], indexing='ij'),
                           axis=-1).reshape(8, 3)
        # world = R @ local + T
        wc8 = np.einsum('nij,kj->nki', rot_all[plist], corners) \
            + disp_all[plist][:, None, :]
        wlo[sel] = wc8.min(axis=1)
        whi[sel] = wc8.max(axis=1)
        ent_group[sel] = k
        ent_place[sel] = plist
        pos += len(plist)
    patch_blk = np.empty(npatch, dtype=np.int64)  # candidate -> block
    patch_row = np.empty(npatch, dtype=np.int64)  # candidate -> local row
    ppos = 0
    for bi, b in enumerate(inline):
        ids = b['patch_ids']
        sel = slice(ppos, ppos + len(ids))
        wc = b['wc']
        wlo[ninst + ppos:ninst + ppos + len(ids)] = \
            wc.world_origin + b['row_lo'][ids] * wc.world_scale
        whi[ninst + ppos:ninst + ppos + len(ids)] = \
            wc.world_origin + b['row_hi'][ids] * wc.world_scale
        patch_blk[sel] = bi
        patch_row[sel] = ids
        ppos += len(ids)

    # ---- global TLAS grid over candidates ---------------------------
    world_origin = wlo.min(axis=0).astype(np.float32)
    world_scale = float(max((whi.max(axis=0)
                             - world_origin).max() / (2 ** 16 - 2),
                            1e-12))
    wc_global = WorldCoords(world_origin=world_origin,
                            world_scale=world_scale)

    # levels below the TLAS leaf level (entries embed the BLAS root's
    # subtree; patches carry their own descent depth)
    below = [max(b['nlayers'] - 1, 1) for b in blas]
    below += [int(b['patch_below'].max()) for b in inline
              if len(b['patch_below'])]
    max_below = max(below)

    # TLAS tree over candidate AABBs: SAH wide build (leaf_max=1 —
    # every candidate is its own node) with the Morton recursive-grid
    # grouping as the no-toolchain fallback
    sahb = native.sah_wide_build(wlo, whi, BRANCH, 1) if USE_SAH \
        else None
    if sahb is not None and sahb['depth'] + max_below > 12:
        sahb = None          # ops.mbvh.MAX_LEVELS guard

    if sahb is not None:
        n_tlas_rows = len(sahb['kind'])
        clus_t = sahb['kind'] == 1
        # cluster wide id -> candidate id (single-leaf clusters appear
        # in BFS order, so child_start enumerates leaf_order directly)
        cdst_t = np.flatnonzero(clus_t).astype(np.int64)
        cand_of = sahb['leaf_order'][sahb['child_start'][clus_t]]
        q_lo_t, q_hi_t = _quantize_boxes(
            sahb['node_lo'], sahb['node_hi'], world_origin, world_scale)
        depth = sahb['depth'] + max_below
    else:
        def quant(v):
            return np.clip((v - world_origin) / world_scale,
                           0, 2 ** 16 - 2).astype(np.uint32)

        q_lo = quant(wlo)
        q_lo[q_lo > 0] -= 1
        q_hi = quant(whi) + 1
        morton = morton_codes_3d(quant((wlo + whi) * 0.5))
        order = native.radix_argsort_u64(morton)
        if order is None:
            order = np.argsort(morton, kind='stable')
        q_lo, q_hi, morton = q_lo[order], q_hi[order], morton[order]

        groupings, layer_lo, layer_hi = _grouping_rounds(
            q_lo, q_hi, morton, ncand, target_degree)
        nlayers_t = len(groupings)
        layer_sizes = [len(g[0]) for g in groupings]
        n_tlas = sum(layer_sizes)

        # row ids: [TLAS internals root-first] [leaf-level candidates
        # in Morton order] [BLAS blocks] [inline blocks]
        id_base = {}
        running = 0
        for k in range(nlayers_t - 1, -1, -1):
            id_base[k] = running
            running += layer_sizes[k]
        assert running == n_tlas
        leaf_base = n_tlas
        n_tlas_rows = n_tlas + ncand
        # depth = deepest level index + 1: TLAS internals occupy
        # levels 0..nlayers_t-1, leaf candidates level nlayers_t;
        # below that, entries add max(blas nlayers - 1, 1) levels (the
        # embedded BLAS root's subtree) and each patch its own count
        depth = nlayers_t + 1 + max_below

    blas_base = []
    running = n_tlas_rows
    for b in blas:
        blas_base.append(running)
        running += len(b['rows'])
    inline_base = []
    for b in inline:
        inline_base.append(running)
        running += len(b['rows'])
    total_rows = running

    rows = np.zeros((total_rows, ROW_WIDTH), dtype=np.uint32)

    # ---- BLAS + inline blocks (offset internal child pointers) -----
    for b, base in zip(blas + inline, blas_base + inline_base):
        blk = b['rows'].copy()
        internal = (blk[:, HDR_KIND] & KIND_CLUSTER) == 0
        blk[internal, HDR_BASE] += np.uint32(base)
        rows[base:base + len(blk)] = blk

    # ---- leaf-level rows (built in candidate order, then permuted) -
    leaf_rows = np.zeros((ncand, ROW_WIDTH), dtype=np.uint32)
    for k, b in enumerate(blas):
        sel = np.flatnonzero(ent_group == k)
        root = rows[blas_base[k]]          # BLAS root (already offset)
        tmpl = np.zeros(ROW_WIDTH, dtype=np.uint32)
        if b['nlayers'] > 1:
            # embed the internal root: its children become ours
            tmpl[HDR_KIND] = (root[HDR_KIND]
                              & np.uint32(0xFFFFFF00)) \
                | np.uint32(KIND_ENTRY | KIND_LOCAL)
            tmpl[HDR_BASE] = root[HDR_BASE]
            tmpl[BOX_OFF:BOX_OFF + 3 * BRANCH] = \
                root[BOX_OFF:BOX_OFF + 3 * BRANCH]
        else:
            # root is a single cluster: one child box = mesh bounds
            tmpl[HDR_KIND] = np.uint32(KIND_ENTRY | KIND_LOCAL
                                       | (1 << 8))
            tmpl[HDR_BASE] = np.uint32(blas_base[k])
            lo, hi = b['bounds']
            wc = b['wc']
            qlo = np.clip((lo - wc.world_origin) / wc.world_scale,
                          0, 2 ** 16 - 2).astype(np.uint32)
            qlo[qlo > 0] -= 1
            qhi = np.clip((hi - wc.world_origin) / wc.world_scale,
                          0, 2 ** 16 - 2).astype(np.uint32) + 1
            box = np.full((3, BRANCH), 0xFFFF, dtype=np.uint32)
            box[:, 0] = qlo | (qhi << 16)
            tmpl[BOX_OFF:BOX_OFF + 3 * BRANCH] = box.reshape(-1)
        leaf_rows[sel] = tmpl[None, :]
        _write_f32(leaf_rows, sel, IBOX_ORIGIN_OFF, b['wc'].world_origin)
        _write_f32(leaf_rows, sel, IBOX_SCALE_OFF,
                   np.repeat(b['wc'].world_scale, 3))
        plist = ent_place[sel]
        xf = np.concatenate([rot_all[plist].reshape(-1, 9),
                             disp_all[plist]], axis=1) \
            .astype(np.float32)                          # (n,12)
        leaf_rows[sel[:, None], XFORM_OFF + np.arange(12)[None, :]] = \
            xf.view(np.uint32)
        leaf_rows[sel, TRI_BASE_OFF] = nt[plist].astype(np.uint32)
    # patches: copies of the (already offset) inline block rows
    if npatch:
        leaf_rows[ninst:] = rows[
            np.asarray(inline_base, dtype=np.int64)[patch_blk]
            + patch_row]

    if sahb is not None:
        # ---- SAH TLAS: candidates at their cluster-node wide ids,
        # internal rows over global per-node grid boxes --------------
        rows[cdst_t] = leaf_rows[cand_of]
        idst_t = np.flatnonzero(~clus_t).astype(np.int64)
        _emit_internal_rows(rows, idst_t, sahb['child_start'][~clus_t],
                            sahb['child_count'][~clus_t], 0,
                            q_lo_t, q_hi_t, world_origin,
                            np.repeat(np.float32(world_scale), 3),
                            frame_local=False)
    else:
        rows[leaf_base:leaf_base + ncand] = leaf_rows[order]

        # ---- TLAS internal rows (Morton layers) ---------------------
        for k in range(nlayers_t):
            fc, nc = groupings[k]
            dst = id_base[k] + np.arange(len(fc))
            if k == 0:
                child_base, child_lo, child_hi = leaf_base, q_lo, q_hi
            else:
                child_base = id_base[k - 1]
                child_lo, child_hi = layer_lo[k - 1], layer_hi[k - 1]
            _emit_internal_rows(rows, dst, fc, nc, child_base,
                                child_lo, child_hi, world_origin,
                                np.repeat(np.float32(world_scale), 3),
                                frame_local=False)

    ntris = int(sum(len(m.triangles) for m, _, p in inst_groups)
                + sum(b['ntris'] for b in inline))
    return MBVH(wc_global, rows, total_rows, depth, ntris,
                instanced=True)

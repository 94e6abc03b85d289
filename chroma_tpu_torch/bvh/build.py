"""BVH construction, fully vectorized on the host CPU.

A copy of chroma_tpu/bvh/build.py, cut to what the port calls: the
recursive-grid BVH that the geometry loader attaches (its world grid is
the packed tables' ``legacy_world_*``) and the Morton helpers of the
MBVH builder.  The reference builds its BVH with CUDA kernels
(chroma/gpu/bvh.py, chroma/cuda/bvh.cu, chroma/bvh/grid.py); every one
of them is a data-parallel array op, so the tree is built with
vectorized numpy on the host.

Node quantization matches the reference exactly (truncate, then widen
the box by one unit on each side: chroma/cuda/bvh.cu make_leaves).
"""
import numpy as np

from chroma_tpu_torch.bvh.bvh import (BVH, WorldCoords, CHILD_BITS,
                                      NCHILD_MASK, to_uint4, from_uint4)

MAX_CHILD = 2 ** (32 - CHILD_BITS) - 1


def spread3_16(x):
    """Spread the low 16 bits of each element to every 3rd bit slot."""
    x = np.asarray(x, dtype=np.uint64)
    x = (x | (x << np.uint64(16))) & np.uint64(0x00000000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x000000F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x00000C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x0000249249249249)
    return x


def morton_codes_3d(q):
    """Interleave (n,3) quantized uint coordinates into 48-bit Morton
    codes (x lowest bit)."""
    return (spread3_16(q[:, 0])
            | (spread3_16(q[:, 1]) << np.uint64(1))
            | (spread3_16(q[:, 2]) << np.uint64(2)))


def create_leaf_nodes(mesh, morton_bits=16, round_to_multiple=1):
    """Quantize per-triangle AABBs into packed leaf nodes.

    Returns (world_coords, nodes[(n,) uint4], morton_codes[(n,) u64]).
    Leaf child ids are triangle indices.  The fixed-point grid spans the
    mesh bounds with scale = max extent / (2^16 - 2) so that the +1
    widening at the top stays in range.
    """
    vertices = mesh.vertices
    triangles = mesh.triangles

    world_origin = vertices.min(axis=0)
    world_scale = np.max(vertices.max(axis=0) - world_origin) / (2 ** 16 - 2)
    world_coords = WorldCoords(world_origin=world_origin,
                               world_scale=world_scale)

    tv = vertices[triangles]                      # (T,3,3)
    lower = tv.min(axis=1)
    upper = tv.max(axis=1)
    centroid = tv.mean(axis=1)

    def quantize(v):
        # truncation, matching the device builder
        return ((v - world_origin) / world_scale).astype(np.uint32)

    q_lower = quantize(lower)
    q_lower[q_lower > 0] -= 1          # widen down, clamped at 0
    q_upper = quantize(upper) + 1      # widen up
    q_centroid = quantize(centroid)

    morton = ((morton_codes_3d(q_centroid))
              >> np.uint64(16 - morton_bits))

    n = len(triangles)
    npad = -n % round_to_multiple
    packed = np.zeros((n + npad, 4), dtype=np.uint32)
    packed[:n, 0] = q_lower[:, 0] | (q_upper[:, 0] << 16)
    packed[:n, 1] = q_lower[:, 1] | (q_upper[:, 1] << 16)
    packed[:n, 2] = q_lower[:, 2] | (q_upper[:, 2] << 16)
    packed[:n, 3] = np.arange(n, dtype=np.uint32)

    return world_coords, to_uint4(packed), morton


def merge_nodes_detailed(nodes, first_child, nchild):
    """Build one parent per (first_child, nchild) run of contiguous
    children: AABB = union of children, w = first_child | nchild<<28.
    (reference: chroma/cuda/bvh.cu make_parents_detailed)"""
    arr = from_uint4(nodes)
    first_child = np.asarray(first_child, dtype=np.int64)
    nchild = np.asarray(nchild, dtype=np.uint32)

    lo = arr[:, :3] & 0xFFFF
    hi = arr[:, :3] >> 16

    # segments are contiguous and sorted, so reduceat does the unions.
    # reduceat needs strictly valid starts; each run covers
    # [first_child[i], first_child[i]+nchild[i]).  Runs from the
    # MAX_CHILD split can be shorter than the gap to the next start
    # never happens (runs tile the child array exactly).
    seg_lo = np.minimum.reduceat(lo, first_child, axis=0)
    seg_hi = np.maximum.reduceat(hi, first_child, axis=0)

    parents = np.empty((len(first_child), 4), dtype=np.uint32)
    parents[:, :3] = seg_lo | (seg_hi << 16)
    parents[:, 3] = (first_child.astype(np.uint32)
                     | (nchild << np.uint32(CHILD_BITS)))
    return to_uint4(parents)


def concatenate_layers(layers):
    """Stack layers root-first into one node array, fixing up child ids
    so each internal node points at its children in the next layer.
    Returns (nodes, layer_bounds).  (reference: chroma/gpu/bvh.py:239)"""
    layer_bounds = np.insert(np.cumsum([len(l) for l in layers]), 0, 0)
    out = np.empty((int(layer_bounds[-1]), 4), dtype=np.uint32)

    for layer_start, layer_end, layer in zip(layer_bounds[:-1],
                                             layer_bounds[1:], layers):
        arr = from_uint4(np.asarray(layer)).copy()
        if layer_end != layer_bounds[-1]:
            # internal layer: children live at the start of the next
            # layer, so offset the (layer-relative) child ids
            nchild_bits = arr[:, 3] & NCHILD_MASK
            child = arr[:, 3] & ~NCHILD_MASK
            arr[:, 3] = (child + np.uint32(layer_end)) | nchild_bits
        out[layer_start:layer_end] = arr
    return to_uint4(out), layer_bounds


def collapse_chains(nodes, layer_bounds):
    """Replace single-child internal nodes with their child, bottom-up,
    so traversal skips degenerate chains.  (reference:
    chroma/cuda/bvh.cu collapse_child)"""
    arr = from_uint4(nodes)
    bounds = list(zip(layer_bounds[:-1], layer_bounds[1:]))[:-1]
    bounds.reverse()
    for start, end in bounds:
        w = arr[start:end, 3]
        nchild = w >> CHILD_BITS
        child = w & ~NCHILD_MASK
        mask = nchild == 1
        arr[start:end][mask] = arr[child[mask]]
    return to_uint4(arr)


def _intra_run(run_lengths):
    """[0..k0-1, 0..k1-1, ...] for run lengths k."""
    total = int(np.sum(run_lengths))
    cum = np.cumsum(run_lengths)
    return np.arange(total) - np.repeat(cum - run_lengths, run_lengths)


def _count_unique_in_sorted(a):
    return int((np.ediff1d(a) > 0).sum()) + 1


def _split_excess_runs(first_child, nnodes):
    """Split runs longer than MAX_CHILD into several parents.

    Vectorized: each run of length L becomes ceil(L / MAX_CHILD)
    parents starting every MAX_CHILD children."""
    run_len = np.ediff1d(first_child, to_end=nnodes - first_child[-1])
    nsplit = -(-run_len // MAX_CHILD)  # ceil
    if (nsplit <= 1).all():
        return first_child
    starts = np.repeat(first_child, nsplit)
    # offset within each run: 0, MAX_CHILD, 2*MAX_CHILD, ...
    cum = np.cumsum(nsplit)
    intra = np.arange(cum[-1]) - np.repeat(cum - nsplit, nsplit)
    return (starts + intra * MAX_CHILD).astype(np.int64)


def make_recursive_grid_bvh(mesh, target_degree=3, verbose=False):
    """Build a BVH with the recursive-grid method (reference:
    chroma/bvh/grid.py): leaves in Morton order; parent layers formed by
    coarsening the Morton grid (right-shifting codes) until the average
    fan-out reaches ``target_degree``, grouping equal codes, splitting
    oversize groups, then collapsing single-child chains."""
    world_coords, leaf_nodes, morton_codes = create_leaf_nodes(mesh)

    order = np.argsort(morton_codes, kind='stable')
    leaf_nodes = leaf_nodes[order]
    morton_codes = morton_codes[order]

    layers = [leaf_nodes]
    while len(layers[0]) > 1:
        top_layer = layers[0]
        nnodes = len(top_layer)

        nunique = _count_unique_in_sorted(morton_codes)
        while nnodes / float(nunique) < target_degree and nunique > 1:
            morton_codes >>= np.uint64(1)
            nunique = _count_unique_in_sorted(morton_codes)

        is_run_start = np.ediff1d(morton_codes,
                                  to_begin=np.uint64(1)) > 0
        first_child = np.flatnonzero(is_run_start).astype(np.int64)
        first_child = _split_excess_runs(first_child, nnodes)
        nchild = np.ediff1d(first_child,
                            to_end=nnodes - first_child[-1]).astype(np.uint32)

        if verbose:
            print('Merging %d nodes to %d parents'
                  % (nnodes, len(first_child)))
        assert (nchild > 0).all() and (nchild <= MAX_CHILD).all()

        parents = merge_nodes_detailed(top_layer, first_child, nchild)
        layers = [parents] + layers
        # split sub-runs share their run's code, so indexing at each
        # (possibly split) run start yields the parent codes directly
        morton_codes = morton_codes[first_child]

    nodes, layer_bounds = concatenate_layers(layers)
    nodes = collapse_chains(nodes, layer_bounds)
    return BVH(world_coords, nodes, layer_bounds[:-1])

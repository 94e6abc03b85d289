"""BVH quality tools: surface-area node pairing and child ordering (the
port's copy of chroma_tpu/bvh/optimize.py).

Parity with the reference's GPU BVH optimizer (reference:
chroma/gpu/bvh.py:269 optimize_layer — greedy minimal-pair-area
sibling search; :132 area_sort_nodes — children sorted by area so big
boxes test first), re-implemented as vectorized numpy over the packed
node array (the ABI of chroma_tpu_torch/bvh/bvh.py).
"""
import numpy as np

from chroma_tpu_torch.bvh.bvh import BVH, unpack_nodes, node_areas


def _pair_area_matrix(lo, hi, lo2, hi2):
    """Surface areas of the unions of boxes (n,3) x (m,3) -> (n,m)."""
    mn = np.minimum(lo[:, None, :], lo2[None, :, :])
    mx = np.maximum(hi[:, None, :], hi2[None, :, :])
    d = (mx - mn).astype(np.float64)
    return (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
            + d[..., 2] * d[..., 0])


def optimize_layer(nodes, chunk=512):
    """Reorder a layer so consecutive pairs have minimal union area.

    Greedy: for each even slot, pick the remaining node whose union
    with it has the smallest surface area and swap it adjacent
    (reference gpu/bvh.py:269 does the same search with CUDA
    min-reductions).  Operates on a packed (N,4)-uint32 node slice;
    returns the permuted copy and the permutation.
    """
    nodes = np.asarray(nodes).copy()
    info = unpack_nodes(nodes)
    lo = np.column_stack([info['xlo'], info['ylo'], info['zlo']]) \
        .astype(np.float64)
    hi = np.column_stack([info['xhi'], info['yhi'], info['zhi']]) \
        .astype(np.float64)
    n = len(nodes)
    perm = np.arange(n)

    for i in range(0, n - 2, 2):
        j0 = i + 1
        # search in manageable chunks; keep the global argmin
        best_j, best_a = j0, np.inf
        for s in range(j0, n, chunk):
            e = min(s + chunk, n)
            areas = _pair_area_matrix(lo[i:i + 1], hi[i:i + 1],
                                      lo[s:e], hi[s:e])[0]
            k = int(np.argmin(areas))
            if areas[k] < best_a:
                best_a = float(areas[k])
                best_j = s + k
        if best_j != j0:
            for arr in (nodes, lo, hi, perm):
                arr[[j0, best_j]] = arr[[best_j, j0]]
    return nodes, perm


def area_sort_children(bvh):
    """Sort each parent's children by area, largest first, so the
    biggest boxes (most likely hits) test earliest (reference
    gpu/bvh.py:132 area_sort_nodes).  Returns a new BVH."""
    nodes = np.asarray(bvh.nodes).copy()
    info = unpack_nodes(nodes)
    leaf = info['nchild'] == 0
    areas = node_areas(nodes).astype(np.float64)

    # iterate layers bottom-up so child pointers of moved nodes stay
    # valid (children move only within their own parent's run)
    offsets = list(bvh.layer_offsets) + [len(nodes)]
    for li in range(len(bvh.layer_offsets) - 1, -1, -1):
        start, end = offsets[li], offsets[li + 1]
        for p in range(start, end):
            if leaf[p]:
                continue
            c0 = int(info['child'][p])
            nc = int(info['nchild'][p])
            if nc <= 1 or c0 < end:
                continue   # only reorder within deeper layers
            order = np.argsort(-areas[c0:c0 + nc], kind='stable')
            nodes[c0:c0 + nc] = nodes[c0 + order]
            areas[c0:c0 + nc] = areas[c0 + order]
            # move the grandchildren pointers along with the nodes
    return BVH(bvh.world_coords, nodes, bvh.layer_offsets)


def layer_area(nodes):
    """Total surface area of a packed node slice (fixed-point units)."""
    return float(node_areas(np.asarray(nodes)).astype(np.float64).sum())

"""The escape-rope BVH walker: a second closest-hit walk, independent of
the MBVH code.

Counterpart of chroma_tpu/ops/mesh.py.  The reference walks its BVH
with one thread per ray and a stack (chroma/cuda/mesh.h:41); this walk
needs no stack: every node carries its escape pointer ("rope",
ops/geometry_pack.compute_escape_pointers), the node a depth-first walk
goes to when the node is skipped or finished.  A ray's state is one
node cursor and its best hit; an iteration reads one node, descends
into a hit internal node, tests a leaf's triangle, and otherwise
follows the rope.

Plain PyTorch on any device: each iteration steps only the rays still
walking.  It reads the ``nodes``, ``escape`` and ``tri_vertices``
tables, packed for meshes with a BVH of at most
``geometry_pack.LEGACY_WALKER_MAX_TRIANGLES`` triangles; it serves as
the brute-force-checked oracle the MBVH kernels are held against.
"""
import torch

from chroma_tpu_torch.ops.intersect import (intersect_box,
                                            intersect_triangle, normalize)

CHILD_BITS = 28
CHILD_MASK = 0x0FFFFFFF
SENTINEL = 0xFFFFFFFF
_U32 = 0xFFFFFFFF


def _dequantize(packed_xyz, world_origin, world_scale):
    """(m, 3) node words (lo | hi << 16) -> the box's world corners
    (reference: chroma/cuda/geometry.h get_node)."""
    lower = (packed_xyz & 0xFFFF).to(torch.float32)
    upper = ((packed_xyz >> 16) & 0xFFFF).to(torch.float32)
    return (world_origin + lower * world_scale,
            world_origin + upper * world_scale)


def intersect_mesh(origin, direction, tables, last_hit_triangle=None,
                   max_iters=262144):
    """Closest hit of each ray through the escape-rope BVH.

    ``origin``, ``direction`` (N, 3) f32, the directions normalized;
    ``last_hit_triangle`` (N,) int32 triangle each ray may not hit
    again (reference: chroma/cuda/mesh.h:82), or None.  Returns
    (triangle (N,) int32, -1 on a miss; distance (N,) f32, inf on a
    miss)."""
    n = origin.shape[0]
    dev = origin.device
    if last_hit_triangle is None:
        last_hit_triangle = torch.full((n,), -1, dtype=torch.int32,
                                       device=dev)
    inv_dir = 1.0 / direction
    noid = -origin * inv_dir
    nodes = tables.nodes.to(torch.int64) & _U32
    escape = tables.escape.to(torch.int64) & _U32
    n_nodes = nodes.shape[0]
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    min_dist = torch.full((n,), torch.inf, device=dev)
    for _ in range(max_iters):
        idx = torch.nonzero(cur != SENTINEL).squeeze(1)
        if idx.numel() == 0:
            break
        node = torch.clamp(cur[idx], max=n_nodes - 1)
        packed = nodes[node]
        lower, upper = _dequantize(packed[:, :3],
                                   tables.legacy_world_origin,
                                   tables.legacy_world_scale)
        box_hit, box_dist = intersect_box(noid[idx], inv_dir[idx], lower,
                                          upper)
        md = min_dist[idx]
        hit = box_hit & (box_dist <= md)
        w = packed[:, 3]
        child = w & CHILD_MASK
        is_leaf = (w >> CHILD_BITS) == 0
        # a leaf: test its triangle
        do_tri = hit & is_leaf & (child != last_hit_triangle[idx])
        tv = tables.tri_vertices[torch.where(do_tri, child, 0)]
        t_hit, t_dist = intersect_triangle(origin[idx], direction[idx],
                                           tv[:, 0], tv[:, 1], tv[:, 2])
        better = do_tri & t_hit & (t_dist < md)
        best_tri[idx] = torch.where(better, child.to(torch.int32),
                                    best_tri[idx])
        min_dist[idx] = torch.where(better, t_dist, md)
        # descend into a hit internal node, else follow the rope
        cur[idx] = torch.where(hit & ~is_leaf, child, escape[node])
    return best_tri, min_dist


def chunked(fn, wave=131072):
    """``fn`` over arrays cut into waves of ``wave`` rows along the first
    axis, its (tuple of) results joined, so the slow rays of a wave stall
    only that wave."""
    def wrapper(*arrays):
        n = arrays[0].shape[0]
        parts = [fn(*[a[lo:lo + wave] for a in arrays])
                 for lo in range(0, n, wave)]
        return tuple(torch.cat(r) for r in zip(*parts))
    return wrapper


def distance_to_mesh(origin, direction, tables, wave=131072):
    """(triangle, distance) of each ray from its origin to the mesh,
    distance inf on a miss, the directions normalized here (reference:
    chroma/cuda/mesh.h distance_to_mesh kernel)."""
    direction = normalize(direction)
    if origin.shape[0] <= wave:
        return intersect_mesh(origin, direction, tables)
    return chunked(lambda o, d: intersect_mesh(o, d, tables),
                   wave)(origin, direction)

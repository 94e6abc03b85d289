"""Closest-hit queries against the MBVH.

Counterpart of chroma_tpu/ops/mbvh.py.  ``intersect_mesh`` keeps that
module's contract and dispatches on where the tensors live: CUDA tensors
go to the hand-written walker kernel, CPU tensors to its plain PyTorch
version (ops/mbvh_walk.py).  Both compute the TPU walker's traversal, so
results do not depend on the device.
"""
import numpy as np
import torch

from chroma_tpu_torch.ops import mbvh_walk

MAX_LEVELS = 12


def tquant_scale(tables):
    """Entry-distance quantization: 65535 / world-box diagonal, in
    float32 arithmetic as the JAX package computes it.  Returned as a
    Python float holding the float32 value."""
    ws = np.float32(tables.world_scale.item())
    return float(np.float32(65535.0)
                 / (ws * np.float32(65535.0) * np.float32(1.7320509)))


def intersect_mesh(origin, direction, tables, last_hit_triangle=None,
                   active=None, max_iters=65536):
    """Closest-hit intersection against the MBVH.

    Args:
      origin, direction: (N,3) f32, direction normalized.
      tables: GeometryTables (with mbvh_rows), on the rays' device.
      last_hit_triangle: (N,) i32 triangle to skip, or None.
      active: (N,) bool rays to trace, or None for all.

    Returns dict with:
      triangle: (N,) i32 (-1 = miss)
      distance: (N,) f32 (inf on miss)
      normal:   (N,3) f32 geometric normal (unnormalized cross product)
      material_code: (N,) i32 packed material/surface code (u32 bits)
      incomplete: (N,) bool rays stopped by max_iters
    """
    n = origin.shape[0]
    dev = origin.device
    if last_hit_triangle is None:
        last_hit_triangle = torch.full((n,), -1, dtype=torch.int32,
                                       device=dev)
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    walk = mbvh_walk.closest_hit_plain if dev.type == 'cpu' \
        else mbvh_walk.closest_hit_cuda
    return walk(tables.mbvh_rows, origin.contiguous(),
                direction.contiguous(), last_hit_triangle.contiguous(),
                active.contiguous(), tquant_scale(tables),
                int(tables.mbvh_depth), bool(tables.mbvh_instanced),
                min(int(max_iters), 65536))

"""Vector primitives on (..., 3) tensors and the ray/triangle and
ray/box tests of the escape-rope walker (ops/mesh.py).

Counterpart of chroma_tpu/ops/intersect.py.  Sums over the last axis
are written out term by term, ((x0 + x1) + x2), so the result does not
depend on how a reduction kernel orders its adds on either device.
"""
import torch

EPSILON = 1e-6
FLT_EPSILON = 1.1920929e-07


def dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def norm(a):
    return torch.sqrt(dot(a, a))


def normalize(a):
    return a / norm(a)[..., None]


def intersect_triangle(origin, direction, v0, v1, v2):
    """(hit, distance): Moller-Trumbore ray/triangle test, broadcast over
    leading axes.  ``direction`` must be normalized.  Barycentrics may
    stray EPSILON outside [0, 1] and hits need t > EPSILON (reference:
    chroma/cuda/intersect.h:25)."""
    edge1 = v1 - v0
    edge2 = v2 - v0
    h = cross(direction, edge2)
    a = dot(edge1, h)
    not_parallel = torch.abs(a) > FLT_EPSILON
    f = 1.0 / torch.where(not_parallel, a, torch.ones_like(a))
    s = origin - v0
    u = f * dot(s, h)
    q = cross(s, edge1)
    v = f * dot(direction, q)
    t = f * dot(edge2, q)
    hit = (not_parallel & (u >= -EPSILON) & (u <= 1.0 + EPSILON)
           & (v >= -EPSILON) & (u + v <= 1.0 + EPSILON) & (t > EPSILON))
    return hit, t


def intersect_box(neg_origin_inv_dir, inv_dir, lower, upper):
    """(hit, distance to the box): slab test on precomputed 1/dir and
    -origin/dir (reference: chroma/cuda/intersect.h:106).  Axes with an
    infinite 1/dir (a ray parallel to the slab) are skipped."""
    finite = torch.isfinite(inv_dir)
    t0 = lower * inv_dir + neg_origin_inv_dir
    t1 = upper * inv_dir + neg_origin_inv_dir
    tsmall = torch.where(finite, torch.minimum(t0, t1), -torch.inf)
    tbig = torch.where(finite, torch.maximum(t0, t1), torch.inf)
    tmin = torch.clamp(tsmall.amax(dim=-1), min=0.0)
    tmax = tbig.amin(dim=-1)
    return tmin <= tmax, tmin

"""Vector primitives on (..., 3) tensors.

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

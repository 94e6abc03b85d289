"""Small vector/rotation helpers used by geometry construction.

(parity: chroma/transform.py — Rodrigues rotations and normalization)
"""
import numpy as np


def norm(x):
    """Euclidean norm along the last axis."""
    return np.sqrt((np.asarray(x) ** 2).sum(-1))


def normalize(x):
    """Unit vector(s) in the direction of ``x``."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    return (x / norm(x)[:, None]).squeeze()


def get_perp(x):
    """An arbitrary vector perpendicular to ``x``."""
    a = np.zeros(3)
    a[np.argmin(np.abs(x))] = 1
    return np.cross(a, x)


def make_rotation_matrix(phi, n):
    """Rotation matrix: angle ``phi`` counter-clockwise about axis ``n``
    (looking towards +infinity).  Rodrigues form."""
    n = normalize(n)
    skew = np.array([[0, n[2], -n[1]],
                     [-n[2], 0, n[0]],
                     [n[1], -n[0], 0]])
    return (np.cos(phi) * np.identity(3)
            + (1 - np.cos(phi)) * np.outer(n, n)
            + np.sin(phi) * skew)


def rotate(x, phi, n):
    """Rotate point array ``x`` by angle ``phi`` about axis ``n``."""
    n = normalize(n)
    x = np.atleast_2d(x)
    phi = np.atleast_1d(phi)
    cos_phi = np.cos(phi)[:, None]
    sin_phi = np.sin(phi)[:, None]
    return (x * cos_phi
            + n * np.dot(x, n)[:, None] * (1 - cos_phi)
            + np.cross(x, n) * sin_phi).squeeze()


def rotate_matrix(x, phi, n):
    """rotate() via an explicit rotation matrix (single angle only)."""
    return np.inner(np.asarray(x), make_rotation_matrix(phi, n))


def matrix_to_axis_angle(rot_matrix):
    """Decompose a rotation matrix into (axis, angle)."""
    m = np.asarray(rot_matrix, dtype=float)
    angle = np.arccos(np.clip((np.trace(m) - 1.0) / 2.0, -1.0, 1.0))
    if angle < 1e-12:
        return np.array([0.0, 0.0, 1.0]), 0.0
    # note the transposed-index convention matches make_rotation_matrix
    axis = np.array([m[1, 2] - m[2, 1],
                     m[2, 0] - m[0, 2],
                     m[0, 1] - m[1, 0]]) / (2.0 * np.sin(angle))
    return axis, angle

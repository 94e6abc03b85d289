"""Random samplers used by generators and tests (parity: chroma/sample.py)."""
import numpy as np


def uniform_sphere(size=None, dtype=np.double):
    """Uniform point(s) on the unit sphere.

    Uses the cylindrical-projection construction (uniform z, uniform
    azimuth) — the same distribution as the device sampler
    (reference: chroma/cuda/random.h uniform_sphere).
    """
    theta = np.random.uniform(0.0, 2 * np.pi, size)
    u = np.random.uniform(-1.0, 1.0, size)
    c = np.sqrt(1 - u ** 2)
    if size is None:
        return np.array([c * np.cos(theta), c * np.sin(theta), u],
                        dtype=dtype)
    points = np.empty((size, 3), dtype)
    points[:, 0] = c * np.cos(theta)
    points[:, 1] = c * np.sin(theta)
    points[:, 2] = u
    return points


def flashlight(phi=np.pi / 4, direction=(0, 0, 1), size=None,
               dtype=np.double):
    """Uniform directions within a cone of half-angle ``phi`` around
    ``direction``."""
    from chroma_tpu_torch.transform import make_rotation_matrix, normalize, get_perp
    theta = np.random.uniform(0.0, 2 * np.pi, size)
    u = np.random.uniform(np.cos(phi), 1.0, size)
    c = np.sqrt(1 - u ** 2)
    points = np.column_stack([c * np.cos(theta), c * np.sin(theta),
                              np.atleast_1d(u)]).astype(dtype)
    direction = normalize(direction)
    if np.allclose(direction, [0, 0, 1]):
        out = points
    else:
        axis = np.cross([0, 0, 1], direction)
        angle = np.arccos(np.clip(np.dot([0, 0, 1], direction), -1, 1))
        out = np.inner(points, make_rotation_matrix(-angle, axis))
    return out if size is not None else out[0]

"""Host utilities the port uses (counterpart of chroma_tpu/tools.py)."""
import numpy as np

from chroma_tpu_torch.transform import normalize


def offset(points, x):
    """Offset a 2D polyline inward/outward by perpendicular distance
    ``x``: intersect each pair of adjacent offset segments.
    (reference: chroma/tools.py — used to build the inner PMT envelope)"""
    points = np.asarray(points, dtype=float)
    seg = points[1:] - points[:-1]
    # unit normals of each segment (rotate by -90 degrees)
    normals = np.column_stack([seg[:, 1], -seg[:, 0]])
    normals /= np.linalg.norm(normals, axis=1)[:, None]

    a = points[:-1] + normals * x   # offset segment start
    b = points[1:] + normals * x    # offset segment end

    out = [a[0]]
    for i in range(len(seg) - 1):
        # intersect offset segment i with segment i+1
        d1, d2 = seg[i], seg[i + 1]
        p1, p2 = a[i], a[i + 1]
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(denom) < 1e-12:
            out.append(b[i])
        else:
            t = ((p2[0] - p1[0]) * d2[1] - (p2[1] - p1[1]) * d2[0]) / denom
            out.append(p1 + t * d1)
    out.append(b[-1])
    return np.asarray(out)


def interleave3d(arr, bits):
    """Morton-interleave (n,3) integer coordinates using ``bits`` bits
    per axis."""
    arr = np.asarray(arr, dtype=np.uint64)
    result = np.zeros(len(arr), dtype=np.uint64)
    for i in range(bits):
        for j in range(3):
            result |= ((arr[:, 2 - j] >> np.uint64(i)) & np.uint64(1)) \
                << np.uint64(3 * i + j)
    return result


def argsort_direction(dir):
    """Return ordering of direction vectors that groups nearby
    directions (Morton order on the unit sphere) — improves BVH
    traversal memory coherence (reference: chroma/tools.py:175)."""
    dir = normalize(np.atleast_2d(dir))
    quantized = np.clip(((dir + 1.0) * 0.5 * 1023).astype(np.int64),
                        0, 1023)
    morton = interleave3d(quantized, 10)
    return np.argsort(morton)

"""Procedural mesh primitives (parity: chroma/make.py).

linear_extrude / rotate_extrude build closed meshes from 2D profiles;
box, cube, cylinder, sphere, torus, convex_polygon build common solids.
All construction is vectorized numpy.
"""
import numpy as np

from chroma_tpu_torch.geometry import Mesh
from chroma_tpu_torch.transform import rotate


def _grid_triangles(grid):
    """Triangulate a 2D grid of vertex indices into a closed band mesh.

    ``grid``: (rows, cols) int array of vertex indices.  Adjacent rows
    are stitched with two triangles per quad; columns wrap around
    (column j connects to column j+1 mod cols) — matching the
    reference's mesh_grid stitching (reference: chroma/make.py:6).
    """
    a = grid[:-1]                      # (rows-1, cols)
    b = grid[1:]
    a_next = np.roll(a, -1, axis=1)
    b_next = np.roll(b, -1, axis=1)

    t1 = np.stack([a, b, b_next], axis=-1).reshape(-1, 3)
    t2 = np.stack([a, b_next, a_next], axis=-1).reshape(-1, 3)
    return np.concatenate([t1, t2])


def linear_extrude(x1, y1, height, x2=None, y2=None, center=None,
                   endcaps=True):
    """Extrude the (counter-clockwise) polygon (x1,y1) along z by
    ``height``.  (x2,y2) gives a tapered top profile.  With ``endcaps``
    the solid is closed by triangle fans to the profile centroids.
    (reference: chroma/make.py:22)
    """
    x1 = np.asarray(x1, dtype=float)
    y1 = np.asarray(y1, dtype=float)
    if len(x1) != len(y1):
        raise Exception('`x` and `y` arrays must have the same length.')
    x2 = x1 if x2 is None else np.asarray(x2, dtype=float)
    y2 = y1 if y2 is None else np.asarray(y2, dtype=float)
    if len(x2) != len(y2) or len(x2) != len(x1):
        raise Exception('`x` and `y` arrays must have the same length.')

    n = len(x1)
    zlo, zhi = -height / 2.0, height / 2.0
    rings = []
    if endcaps:
        rings.append(np.column_stack([np.zeros(n), np.zeros(n),
                                      np.full(n, zlo)]))
    rings.append(np.column_stack([x1, y1, np.full(n, zlo)]))
    rings.append(np.column_stack([x2, y2, np.full(n, zhi)]))
    if endcaps:
        rings.append(np.column_stack([np.zeros(n), np.zeros(n),
                                      np.full(n, zhi)]))

    vertices = np.concatenate(rings)
    if center is not None:
        vertices = vertices + np.asarray(center, dtype=float)

    nrings = len(rings)
    grid = np.arange(nrings * n).reshape(nrings, n)
    triangles = _grid_triangles(grid[::-1])
    return Mesh(vertices, triangles, remove_duplicate_vertices=True)


def rotate_extrude(x, y, nsteps=64):
    """Revolve the profile (x,y) about the y axis in ``nsteps`` angular
    steps.  The profile should run counter-clockwise or the mesh is
    inside out.  (reference: chroma/make.py:71)
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    if len(x) != len(y):
        raise Exception('`x` and `y` arrays must have the same length.')

    points = np.column_stack([x, y, np.zeros(len(x))])
    angles = np.linspace(0, 2 * np.pi, nsteps, endpoint=False)
    vertices = np.concatenate([rotate(points, phi, (0, -1, 0)).reshape(-1, 3)
                               for phi in angles])
    # rows = profile points, columns = angular steps (which wrap around)
    grid = np.arange(len(vertices)).reshape(nsteps, len(points)).T[::-1]
    triangles = _grid_triangles(grid)
    return Mesh(vertices, triangles, remove_duplicate_vertices=True)


def box(dx, dy, dz, center=(0, 0, 0)):
    """Axis-aligned box with side lengths dx, dy, dz."""
    return linear_extrude([-dx / 2, dx / 2, dx / 2, -dx / 2],
                          [-dy / 2, -dy / 2, dy / 2, dy / 2],
                          height=dz, center=center)


def cube(size=1, height=None, center=(0, 0, 0)):
    """Cube with side length ``size``."""
    if height is None:
        height = size
    return box(size, size, height, center=center)


def cylinder(radius=1, height=2, radius2=None, nsteps=64):
    """Cylinder (or cone frustum if radius2 differs) along y."""
    if radius2 is None:
        radius2 = radius
    return rotate_extrude([0, radius, radius2, 0],
                          [-height / 2, -height / 2, height / 2, height / 2],
                          nsteps)


def cylinder_along_z(radius, height, points=100):
    angles = np.linspace(0, 2 * np.pi, points, endpoint=False)
    return linear_extrude(radius * np.cos(angles), radius * np.sin(angles),
                          height)


def segmented_cylinder(radius, height, nsteps=64, nsegments=100):
    """Cylinder whose profile is subdivided into ~nsegments points."""
    nseg_r = int((nsegments * radius / (2 * radius + height)) / 2)
    nseg_h = int((nsegments * height / (2 * radius + height)) / 2)
    nseg_r = max(nseg_r, 1)
    nseg_h = max(nseg_h, 1)
    x = np.concatenate([np.linspace(0, radius, nseg_r, endpoint=False),
                        [radius] * nseg_h,
                        np.linspace(radius, 0, nseg_r, endpoint=False), [0]])
    y = np.concatenate([[-height / 2.0] * nseg_r,
                        np.linspace(-height / 2.0, height / 2.0, nseg_h,
                                    endpoint=False),
                        [height / 2.0] * (nseg_r + 1)])
    return rotate_extrude(x, y, nsteps)


def sphere(radius=1, nsteps=64):
    """Sphere of given radius."""
    angles = np.linspace(-np.pi / 2, np.pi / 2, nsteps)
    return rotate_extrude(radius * np.cos(angles), radius * np.sin(angles),
                          nsteps)


def torus(radius, offset, nsteps=64, circle_steps=None):
    """Torus: barrel radius ``radius``, barrel center at ``offset`` from
    the axis."""
    if circle_steps is None:
        circle_steps = nsteps
    angles = np.linspace(0, 2 * np.pi, circle_steps)
    return rotate_extrude(radius * np.cos(angles) + offset,
                          radius * np.sin(angles), nsteps)


def convex_polygon(x, y):
    """Fan-triangulated convex polygon in the x-y plane."""
    vertices = np.column_stack((x, y, np.zeros_like(x)))
    n = len(vertices)
    triangles = np.column_stack([np.zeros(n - 2, dtype=np.int32),
                                 np.arange(1, n - 1, dtype=np.int32),
                                 np.arange(2, n, dtype=np.int32)])
    return Mesh(vertices=vertices, triangles=triangles)

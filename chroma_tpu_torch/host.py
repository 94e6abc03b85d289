"""The host layer a caller of the port builds scenes and photons with.

Geometry construction, the demo detectors, photon sources and the event
model are plain numpy.  The port keeps its own copies of the JAX
package's host modules (event, geometry, detector, make, demo, loader,
cache, bvh, native, generator.photon, ...), under the same module names
inside ``chroma_tpu_torch``; this module re-exports what scripts such as
chip_smoke.py need, so they import from one place.
"""
import numpy as np

from chroma_tpu_torch import demo, event, make  # noqa: F401
from chroma_tpu_torch.geometry import Geometry, Solid, vacuum  # noqa: F401
from chroma_tpu_torch.generator.photon import photon_bomb  # noqa: F401


def tie_geometry():
    """Two coincident copies of one sphere (radius 50), placed as two
    solids of one mesh: every triangle has a twin at the same distance,
    and packed with ``instancing=True`` the two instance entries have
    equal boxes, so walks meet ties in hit distance and in entry codes,
    which the lowest-slot rule decides."""
    mesh = make.sphere(50.0, nsteps=16)
    geo = Geometry(vacuum)
    for _ in range(2):
        geo.add_solid(Solid(mesh, vacuum, vacuum))
    geo.flatten()
    return geo


def axis_rays(origin=(0.731, -1.37, 2.113)):
    """(6, 3) origins and directions: one ray along each of +-x, +-y, +-z
    from ``origin`` (1/dir is infinite on two axes)."""
    d = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                  [0, 0, -1]], dtype=np.float32)
    o = np.tile(np.asarray(origin, np.float32), (6, 1))
    return o, d


def mesh_geometry(mesh):
    """A flattened single-solid Geometry (vacuum on both sides) around a
    Mesh, as the tests pack single meshes."""
    geo = Geometry(vacuum)
    geo.add_solid(Solid(mesh, vacuum, vacuum))
    geo.flatten()
    return geo

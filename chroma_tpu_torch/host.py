"""The numpy host layer the port shares with chroma_tpu.

Geometry construction, the demo detectors, photon generators and the
event model are plain numpy in the JAX package and are used as they are
(the port's own modules also import chroma_tpu.geometry, bvh, cache,
loader, itertoolset, sample and tools, all numpy-only).  This module
re-exports what a caller of the port needs to build scenes and photon
batches, so scripts such as chip_smoke.py import from one package.
"""
from chroma_tpu import demo, event, make  # noqa: F401
from chroma_tpu.geometry import Geometry, Solid, vacuum  # noqa: F401
from chroma_tpu.generator.photon import photon_bomb  # noqa: F401


def mesh_geometry(mesh):
    """A flattened single-solid Geometry (vacuum on both sides) around a
    Mesh, as the tests pack single meshes."""
    geo = Geometry(vacuum)
    geo.add_solid(Solid(mesh, vacuum, vacuum))
    geo.flatten()
    return geo

"""chroma_tpu_torch: the photon Monte Carlo of chroma_tpu on PyTorch and CUDA.

A port of the JAX package ``chroma_tpu`` (which stays the reference):
the same packed detector tables, the same closest-hit walk and photon
physics, the same ``GPUDetector`` / ``GPUPhotons`` / ``Simulation`` API.
It imports torch and never jax, and nothing of ``chroma_tpu``: the numpy
host modules it needs (event, geometry, detector, make, demo, loader,
cache, bvh, generator.photon, the native BVH-build helpers) are its own
copies, under the same module names.  The MBVH walkers are hand-written
CUDA kernels (csrc/), built with nvcc on first use.  Entry points run on
the CUDA card unless the caller passes ``device='cpu'``; on CPU tensors
each kernel's plain PyTorch version runs instead.

The names below are the JAX package's top-level names, from the port's
own numpy host modules, so importing the package loads no kernel.
"""

from chroma_tpu_torch import event
from chroma_tpu_torch.event import Photons, Vertex, Event, Channels
from chroma_tpu_torch.geometry import (Mesh, Solid, Material, Surface,
                                       DichroicProps, Geometry, vacuum,
                                       standard_wavelengths)
from chroma_tpu_torch.detector import Detector
from chroma_tpu_torch import make
from chroma_tpu_torch.stl import mesh_from_stl
from chroma_tpu_torch.loader import (load_geometry_from_string,
                                     create_geometry_from_obj)

__all__ = [
    'event', 'Photons', 'Vertex', 'Event', 'Channels',
    'Mesh', 'Solid', 'Material', 'Surface', 'DichroicProps', 'Geometry',
    'vacuum', 'standard_wavelengths', 'Detector', 'make', 'mesh_from_stl',
    'load_geometry_from_string', 'create_geometry_from_obj',
]

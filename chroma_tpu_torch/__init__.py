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
"""

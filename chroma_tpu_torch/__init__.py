"""chroma_tpu_torch: the photon Monte Carlo of chroma_tpu on PyTorch and CUDA.

A port of the JAX package ``chroma_tpu`` (which stays the reference):
the same packed detector tables, the same closest-hit walk and photon
physics, the same ``GPUDetector`` / ``GPUPhotons`` / ``Simulation`` API.
It imports torch and never jax; from ``chroma_tpu`` it uses only the
numpy host modules (geometry, detector, demo, loader, cache, bvh, event,
generator.photon).  The MBVH walker is a hand-written CUDA kernel
(csrc/mbvh_walk.cu), built with nvcc on first use; on CPU tensors its
plain PyTorch version runs instead.
"""

"""chroma_tpu_torch.bvh: BVH construction on the host (numpy, plus the
native helpers of csrc/host_native.cc)."""
from chroma_tpu_torch.bvh.bvh import BVH, WorldCoords
from chroma_tpu_torch.bvh.build import make_recursive_grid_bvh

__all__ = ['BVH', 'WorldCoords', 'make_recursive_grid_bvh']

"""chroma_tpu_torch.bvh: BVH generation and manipulation on the host
(numpy, plus the native helpers of csrc/host_native.cc)."""
from chroma_tpu_torch.bvh.bvh import (
    BVH, BVHLayerSlice, WorldCoords, OutOfRangeError, CHILD_BITS,
    NCHILD_MASK, uint4, to_uint4, from_uint4, unpack_nodes, node_areas)
from chroma_tpu_torch.bvh.build import (
    make_recursive_grid_bvh, make_simple_bvh, create_leaf_nodes,
    merge_nodes, merge_nodes_detailed, concatenate_layers, collapse_chains,
    MAX_CHILD)

__all__ = ['BVH', 'BVHLayerSlice', 'WorldCoords', 'OutOfRangeError',
           'CHILD_BITS', 'NCHILD_MASK', 'uint4', 'to_uint4', 'from_uint4',
           'unpack_nodes', 'node_areas', 'make_recursive_grid_bvh',
           'make_simple_bvh', 'create_leaf_nodes', 'merge_nodes',
           'merge_nodes_detailed', 'concatenate_layers', 'collapse_chains',
           'MAX_CHILD']

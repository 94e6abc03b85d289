"""Bounding volume hierarchy data structures.

A copy of chroma_tpu/bvh/bvh.py, cut to what the port uses.  Same
packed-node ABI as the reference (reference: chroma/bvh/bvh.py): nodes
are uint32 x 4 records; x/y/z hold the 16-bit fixed-point AABB (lower
bound in the low halfword, upper in the high halfword); w holds
child-id | nchild << CHILD_BITS, with nchild == 0 marking a leaf whose
child id is a triangle index.  Nodes are stored root-first, layer by
layer, and the children of a node are contiguous.

The fixed-point coordinate system ("WorldCoords") maps world position
r = fixed * world_scale + world_origin.
"""
import numpy as np

CHILD_BITS = 28
NCHILD_MASK = np.uint32((0xFFFF << CHILD_BITS) & 0xFFFFFFFF)

# Packed node record dtype (matches device layout: 4 x uint32).
uint4 = np.dtype([('x', '<u4'), ('y', '<u4'), ('z', '<u4'), ('w', '<u4')])


def to_uint4(array):
    """View an (n,4) uint32 array as a structured uint4 record array."""
    array = np.ascontiguousarray(array, dtype=np.uint32)
    return array.view(uint4).reshape(-1)


def from_uint4(nodes):
    """View a structured uint4 record array as an (n,4) uint32 array."""
    return nodes.view(np.uint32).reshape(-1, 4)


class WorldCoords(object):
    """Transformation between world floats and 16-bit fixed point."""

    def __init__(self, world_origin, world_scale):
        self.world_origin = np.array(world_origin, dtype=np.float32)
        self.world_scale = np.float32(world_scale)

    def fixed_to_world(self, fixed):
        return np.asarray(fixed) * self.world_scale + self.world_origin


class BVH(object):
    """A layered, packed bounding volume hierarchy (see module doc).

    ``nodes`` is a uint4 record array, root first; ``layer_offsets``
    gives the start of each depth layer in the node array.
    """

    def __init__(self, world_coords, nodes, layer_offsets):
        self.world_coords = world_coords
        self.nodes = nodes
        self.layer_offsets = list(layer_offsets)
        self.layer_bounds = list(layer_offsets) + [len(nodes)]

    def layer_count(self):
        return len(self.layer_offsets)

    def __len__(self):
        return len(self.nodes)

"""Bounding volume hierarchy data structures (a copy of
chroma_tpu/bvh/bvh.py for the port).

Same packed-node ABI as the reference (reference: chroma/bvh/bvh.py):
nodes are uint32 x 4 records; x/y/z hold the 16-bit fixed-point AABB
(lower bound in the low halfword, upper in the high halfword); w holds
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


def unpack_nodes(nodes):
    """Unpack packed nodes into a record array of AABB halfword fields.

    Returns fields xlo/xhi/ylo/yhi/zlo/zhi (uint16), child (uint32),
    nchild (uint16).
    """
    unpacked_dtype = np.dtype([('xlo', np.uint16), ('xhi', np.uint16),
                               ('ylo', np.uint16), ('yhi', np.uint16),
                               ('zlo', np.uint16), ('zhi', np.uint16),
                               ('child', np.uint32), ('nchild', np.uint16)])
    unpacked = np.empty(shape=len(nodes), dtype=unpacked_dtype)
    for axis in 'xyz':
        unpacked[axis + 'lo'] = nodes[axis] & 0xFFFF
        unpacked[axis + 'hi'] = nodes[axis] >> 16
    unpacked['child'] = nodes['w'] & ~NCHILD_MASK
    unpacked['nchild'] = nodes['w'] >> CHILD_BITS
    return unpacked


class OutOfRangeError(Exception):
    """World coordinates exceed the 16-bit fixed point range."""


class WorldCoords(object):
    """Transformation between world floats and 16-bit fixed point."""

    MAX_INT = 2 ** 16 - 1

    def __init__(self, world_origin, world_scale):
        self.world_origin = np.array(world_origin, dtype=np.float32)
        self.world_scale = np.float32(world_scale)

    def world_to_fixed(self, world):
        """Round world coordinates to nearest fixed point value."""
        fixed = ((np.asarray(world, dtype=np.float64) - self.world_origin)
                 / self.world_scale).round()
        if int(fixed.max()) > WorldCoords.MAX_INT or fixed.min() < 0:
            raise OutOfRangeError('range = (%f, %f)'
                                  % (fixed.min(), fixed.max()))
        return fixed.astype(np.uint16)

    def fixed_to_world(self, fixed):
        return np.asarray(fixed) * self.world_scale + self.world_origin


def node_areas(nodes):
    """Surface areas of packed nodes in fixed-point units."""
    unpacked = unpack_nodes(nodes)
    dx = unpacked['xhi'].astype(float) - unpacked['xlo']
    dy = unpacked['yhi'].astype(float) - unpacked['ylo']
    dz = unpacked['zhi'].astype(float) - unpacked['zlo']
    return 2.0 * (dx * dy + dy * dz + dz * dx)


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

    def get_layer(self, layer_number):
        layer_slice = slice(self.layer_bounds[layer_number],
                            self.layer_bounds[layer_number + 1])
        return BVHLayerSlice(world_coords=self.world_coords,
                             nodes=self.nodes[layer_slice])

    def layer_count(self):
        return len(self.layer_offsets)

    def __len__(self):
        return len(self.nodes)


class BVHLayerSlice(object):
    """A view of one depth layer of a BVH (shares node storage)."""

    def __init__(self, world_coords, nodes):
        self.world_coords = world_coords
        self.nodes = nodes

    def __len__(self):
        return len(self.nodes)

    def areas_fixed(self):
        return node_areas(self.nodes)

    def area_fixed(self):
        return node_areas(self.nodes).sum()

    def area(self):
        """Total node surface area in world units."""
        return self.area_fixed().sum() * self.world_coords.world_scale ** 2

    def get_bounds(self):
        """(lower, upper) world-space bounds of each node in the layer."""
        info = unpack_nodes(self.nodes)
        fixed_lower = np.dstack([info[s] for s in
                                 ['xlo', 'ylo', 'zlo']]).squeeze()
        fixed_upper = np.dstack([info[s] for s in
                                 ['xhi', 'yhi', 'zhi']]).squeeze()
        lower = self.world_coords.fixed_to_world(fixed_lower)
        upper = self.world_coords.fixed_to_world(fixed_upper)
        return np.atleast_2d(lower), np.atleast_2d(upper)

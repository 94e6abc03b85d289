"""STL mesh import: ascii and binary, optionally .bz2-compressed.

(parity: chroma/stl.py).  Parsing is vectorized: binary STL is decoded
with a single structured-dtype read; ascii with one pass over the
vertex lines.  Vertex dedup happens in Mesh(remove_duplicate_vertices).
"""
import bz2
import struct

import numpy as np

from chroma_tpu_torch.geometry import Mesh


def _open(filename, mode='rb'):
    if filename.endswith('.bz2'):
        return bz2.BZ2File(filename)
    return open(filename, mode)


def mesh_from_stl(filename):
    """Load an STL file (ascii or binary, optionally .bz2) as a Mesh."""
    with _open(filename) as f:
        header = f.read(5)
    if header[:5] == b'solid':
        # could still be a binary file with a sneaky header; try ascii
        # first and fall back
        try:
            return mesh_from_ascii_stl(filename)
        except Exception:
            return mesh_from_binary_stl(filename)
    return mesh_from_binary_stl(filename)


def mesh_from_ascii_stl(filename):
    """Mesh from an ascii STL file."""
    with _open(filename) as f:
        data = f.read()
    if isinstance(data, bytes):
        data = data.decode('ascii')

    coords = []
    for line in data.splitlines():
        parts = line.split()
        if parts and parts[0] == 'vertex':
            coords.append([float(parts[1]), float(parts[2]),
                           float(parts[3])])
    coords = np.asarray(coords, dtype=np.float32)
    if len(coords) == 0 or len(coords) % 3 != 0:
        raise ValueError('malformed ascii STL: %d vertex lines'
                         % len(coords))
    triangles = np.arange(len(coords), dtype=np.int32).reshape(-1, 3)
    return Mesh(coords, triangles, remove_duplicate_vertices=True)


# binary STL record: 12B normal + 3*12B vertices + 2B attribute
_RECORD = np.dtype([('normal', '<f4', 3), ('v', '<f4', (3, 3)),
                    ('attr', '<u2')])


def mesh_from_binary_stl(filename):
    """Mesh from a binary STL file."""
    with _open(filename) as f:
        f.read(80)
        (ntriangles,) = struct.unpack('<I', f.read(4))
        records = np.frombuffer(f.read(ntriangles * _RECORD.itemsize),
                                dtype=_RECORD, count=ntriangles)
    coords = records['v'].reshape(-1, 3).astype(np.float32)
    triangles = np.arange(len(coords), dtype=np.int32).reshape(-1, 3)
    return Mesh(coords, triangles, remove_duplicate_vertices=True)

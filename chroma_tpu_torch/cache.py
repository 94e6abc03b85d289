"""On-disk geometry and BVH cache (counterpart of chroma_tpu/cache.py).

Geometries are cached by name, BVHs by MD5 hash of the flattened mesh
(Mesh.md5()) plus an optional name ("default" if unnamed).  Default
location: ~/.chroma_tpu (override with $CHROMA_TPU_CACHE or the
``cache_dir`` argument).  Pickle-based; each file is written under a
temporary name and renamed into place, so a concurrent reader sees the
old file or the new one, never half of one.

The pickles name this package's classes, so they live in ``torch_geo/``
and ``torch_bvh/``, apart from the JAX package's ``geo/`` and ``bvh/``:
neither package ever unpickles (and so imports) the other's modules.
The packed-table cache (ops/table_cache.py) is plain ``.npy`` data and
stays shared.
"""
import copy
import os
import pickle
import tempfile

from chroma_tpu_torch.log import logger


class GeometryNotFoundError(Exception):
    """A requested geometry was not found in the on-disk cache."""


class BVHNotFoundError(Exception):
    """A requested BVH was not found in the on-disk cache."""


def default_cache_dir():
    return os.environ.get('CHROMA_TPU_CACHE',
                          os.path.expanduser('~/.chroma_tpu/'))


def _dump(path, *objs):
    """Pickle ``objs`` into ``path`` atomically."""
    fd, tmp = tempfile.mkstemp(prefix='.tmp.', dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, 'wb') as f:
            for obj in objs:
                pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _ensure_dir(dirname, what):
    if os.path.isdir(dirname):
        return
    if os.path.exists(dirname):
        raise IOError('Path for %s already exists, but is not a '
                      'directory: %s' % (what, dirname))
    logger.info('Creating new cache directory at %s', dirname)
    os.makedirs(dirname, exist_ok=True)


class Cache(object):
    """Read/write access to a cache directory of geometries and BVHs."""

    def __init__(self, cache_dir=None):
        self.cache_dir = cache_dir or default_cache_dir()
        _ensure_dir(self.cache_dir, 'cache')
        self.geo_dir = os.path.join(self.cache_dir, 'torch_geo')
        _ensure_dir(self.geo_dir, 'geometry cache')
        self.bvh_dir = os.path.join(self.cache_dir, 'torch_bvh')
        _ensure_dir(self.bvh_dir, 'BVH cache')

    # ---- geometries -------------------------------------------------

    def get_geometry_filename(self, name):
        return os.path.join(self.geo_dir, name)

    def list_geometry(self):
        return os.listdir(self.geo_dir)

    def save_geometry(self, name, geometry):
        """Pickle ``geometry`` under ``name`` (BVH and un-flattened solid
        lists are stripped; the flat mesh + index arrays survive)."""
        reduced = copy.copy(geometry)
        reduced.bvh = None
        reduced.solids = []
        reduced.solid_rotations = []
        reduced.solid_displacements = []
        _dump(self.get_geometry_filename(name), geometry.mesh.md5(), reduced)

    def load_geometry(self, name):
        path = self.get_geometry_filename(name)
        if not os.path.exists(path):
            raise GeometryNotFoundError(name)
        with open(path, 'rb') as f:
            pickle.load(f)  # skip the mesh hash
            return pickle.load(f)

    def remove_geometry(self, name):
        path = self.get_geometry_filename(name)
        if os.path.exists(path):
            os.remove(path)

    def get_geometry_hash(self, name):
        """Mesh hash for a cached geometry, without unpickling it all."""
        path = self.get_geometry_filename(name)
        if not os.path.exists(path):
            raise GeometryNotFoundError(name)
        with open(path, 'rb') as f:
            return pickle.load(f)

    def load_default_geometry(self):
        return self.load_geometry('.default')

    def set_default_geometry(self, name):
        default_path = self.get_geometry_filename('.default')
        path = self.get_geometry_filename(name)
        if not os.path.exists(path):
            raise GeometryNotFoundError(name)
        if os.path.exists(default_path):
            if os.path.islink(default_path):
                os.remove(default_path)
            else:
                raise IOError('Non-symlink found where expected a symlink: '
                              + default_path)
        os.symlink(path, default_path)

    # ---- BVHs -------------------------------------------------------

    def get_bvh_directory(self, mesh_hash):
        return os.path.join(self.bvh_dir, mesh_hash)

    def get_bvh_filename(self, mesh_hash, name='default'):
        return os.path.join(self.get_bvh_directory(mesh_hash), name)

    def list_bvh(self, mesh_hash):
        d = self.get_bvh_directory(mesh_hash)
        return os.listdir(d) if os.path.isdir(d) else []

    def exist_bvh(self, mesh_hash, name='default'):
        return os.path.isfile(self.get_bvh_filename(mesh_hash, name))

    def save_bvh(self, bvh, mesh_hash, name='default'):
        _ensure_dir(self.get_bvh_directory(mesh_hash), 'BVH directory')
        _dump(self.get_bvh_filename(mesh_hash, name), bvh)

    def load_bvh(self, mesh_hash, name='default'):
        path = self.get_bvh_filename(mesh_hash, name)
        if not os.path.exists(path):
            raise BVHNotFoundError(mesh_hash + ':' + name)
        with open(path, 'rb') as f:
            return pickle.load(f)

    def remove_bvh(self, mesh_hash, name='default'):
        path = self.get_bvh_filename(mesh_hash, name)
        if os.path.exists(path):
            os.remove(path)

"""ctypes loader for the host native helpers (csrc/host_native.cc).

Counterpart of chroma_tpu/native.py.  ``native()`` compiles the source
on first use with g++ into ``chroma_tpu_torch/_build/`` (the same flags
as the JAX package, so both build the same trees) and loads it.  The
library is named by a digest of the flags, the source and the host, and
is written to a temporary name first and then renamed into place, so
processes that build at the same time never load a half-written file.
Every caller handles ``native() is None`` (no toolchain, failed build)
and falls back to numpy.
"""
import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile

import numpy as np

from chroma_tpu_torch.log import logger

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(PKG_DIR, 'csrc', 'host_native.cc')
BUILD_DIR = os.path.join(PKG_DIR, '_build')
CXX_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC', '-std=c++17')

_lib = None
_tried = False


def library_path(build_dir=BUILD_DIR):
    """Where the library for this source, these flags and this host
    lives (``-march=native`` code is specific to the build host)."""
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    h.update(platform.machine().encode())
    h.update(platform.node().encode())
    with open(SOURCE, 'rb') as f:
        h.update(f.read())
    return os.path.join(build_dir, 'host_native_%s.so' % h.hexdigest()[:16])


def build(build_dir=BUILD_DIR):
    """Compile the library unless it is there.  Returns its path."""
    out = library_path(build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix='.host_native.', suffix='.so',
                               dir=build_dir)
    os.close(fd)
    try:
        subprocess.run(['g++', *CXX_FLAGS, SOURCE, '-o', tmp], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def native():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        out = build()
        lib = ctypes.CDLL(out)

        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)

        lib.quantize_and_morton.argtypes = [
            f32p, i32p, ctypes.c_int64, f32p, ctypes.c_float,
            u32p, u32p, u64p]
        lib.radix_sort_u64.argtypes = [u64p, ctypes.c_int64, i64p]
        lib.coarsen_group.restype = ctypes.c_int64
        lib.coarsen_group.argtypes = [u64p, ctypes.c_int64,
                                      ctypes.c_double, ctypes.c_int64,
                                      i64p]
        lib.segment_min_max_u32.argtypes = [u32p, u32p, i64p, i64p,
                                            ctypes.c_int64, u32p, u32p]
        lib.sah_wide_build.restype = ctypes.c_int64
        lib.sah_wide_build.argtypes = [f32p, f32p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64,
                                       i64p]
        lib.sah_wide_fetch.argtypes = [u8p, i64p, i64p, i64p, f32p, f32p]
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.csg_boolean.restype = ctypes.c_int64
        lib.csg_boolean.argtypes = [ctypes.c_int, f64p, ctypes.c_int64,
                                    f64p, ctypes.c_int64]
        lib.csg_fetch.argtypes = [f64p]
        _lib = lib
        logger.info('native helpers loaded from %s', out)
    except Exception as exc:  # no toolchain / build failure: fall back
        logger.info('native helpers unavailable (%s); using numpy', exc)
        _lib = None
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def quantize_and_morton(vertices, triangles, world_origin, world_scale):
    """(lo, hi, morton) for each triangle, or None if no native lib."""
    lib = native()
    if lib is None:
        return None
    vertices = np.ascontiguousarray(vertices, dtype=np.float32)
    triangles = np.ascontiguousarray(triangles, dtype=np.int32)
    origin = np.ascontiguousarray(world_origin, dtype=np.float32)
    nt = len(triangles)
    lo = np.empty((nt, 3), dtype=np.uint32)
    hi = np.empty((nt, 3), dtype=np.uint32)
    morton = np.empty(nt, dtype=np.uint64)
    lib.quantize_and_morton(
        _ptr(vertices, ctypes.c_float), _ptr(triangles, ctypes.c_int32),
        nt, _ptr(origin, ctypes.c_float), ctypes.c_float(world_scale),
        _ptr(lo, ctypes.c_uint32), _ptr(hi, ctypes.c_uint32),
        _ptr(morton, ctypes.c_uint64))
    return lo, hi, morton


def radix_argsort_u64(keys):
    lib = native()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    order = np.empty(len(keys), dtype=np.int64)
    lib.radix_sort_u64(_ptr(keys, ctypes.c_uint64), len(keys),
                       _ptr(order, ctypes.c_int64))
    return order


def coarsen_group(codes, target_degree, max_child):
    """(first_child, coarsened_codes) or None.  codes must be sorted."""
    lib = native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint64).copy()
    first_child = np.empty(len(codes), dtype=np.int64)
    nparent = lib.coarsen_group(_ptr(codes, ctypes.c_uint64), len(codes),
                                ctypes.c_double(target_degree),
                                ctypes.c_int64(max_child),
                                _ptr(first_child, ctypes.c_int64))
    return first_child[:nparent].copy(), codes


def segment_min_max(lo, hi, first_child, nchild):
    lib = native()
    if lib is None:
        return None
    lo = np.ascontiguousarray(lo, dtype=np.uint32)
    hi = np.ascontiguousarray(hi, dtype=np.uint32)
    first_child = np.ascontiguousarray(first_child, dtype=np.int64)
    nchild = np.ascontiguousarray(nchild, dtype=np.int64)
    npar = len(first_child)
    out_lo = np.empty((npar, 3), dtype=np.uint32)
    out_hi = np.empty((npar, 3), dtype=np.uint32)
    lib.segment_min_max_u32(
        _ptr(lo, ctypes.c_uint32), _ptr(hi, ctypes.c_uint32),
        _ptr(first_child, ctypes.c_int64), _ptr(nchild, ctypes.c_int64),
        npar, _ptr(out_lo, ctypes.c_uint32), _ptr(out_hi, ctypes.c_uint32))
    return out_lo, out_hi


def sah_wide_build(leaf_lo, leaf_hi, branch, leaf_max):
    """Binned-SAH wide BVH over ``n`` leaf AABBs, or None without the
    library.  Returns a dict of numpy arrays:

      kind        (W,)  u8   1 = cluster (holds leaves), 0 = internal
      child_start (W,)  i64  internal: first child wide id (children
                             are consecutive); cluster: offset into
                             leaf_order
      child_count (W,)  i64
      leaf_order  (n,)  i64  cluster c owns leaf_order[start:start+cnt]
      node_lo/hi  (W,3) f32  per-node AABBs
      depth       int        tree depth in levels (root = level 1)

    Wide ids are BFS order with root 0.  ``leaf_max`` is the max
    leaves per cluster (1 makes every leaf its own node — the TLAS
    candidate-tree mode)."""
    lib = native()
    if lib is None:
        return None
    leaf_lo = np.ascontiguousarray(leaf_lo, dtype=np.float32)
    leaf_hi = np.ascontiguousarray(leaf_hi, dtype=np.float32)
    n = len(leaf_lo)
    depth = np.zeros(1, dtype=np.int64)
    w = lib.sah_wide_build(
        _ptr(leaf_lo, ctypes.c_float), _ptr(leaf_hi, ctypes.c_float),
        n, branch, leaf_max, _ptr(depth, ctypes.c_int64))
    kind = np.empty(w, dtype=np.uint8)
    child_start = np.empty(w, dtype=np.int64)
    child_count = np.empty(w, dtype=np.int64)
    leaf_order = np.empty(n, dtype=np.int64)
    node_lo = np.empty((w, 3), dtype=np.float32)
    node_hi = np.empty((w, 3), dtype=np.float32)
    lib.sah_wide_fetch(
        _ptr(kind, ctypes.c_uint8), _ptr(child_start, ctypes.c_int64),
        _ptr(child_count, ctypes.c_int64),
        _ptr(leaf_order, ctypes.c_int64),
        _ptr(node_lo, ctypes.c_float), _ptr(node_hi, ctypes.c_float))
    return dict(kind=kind, child_start=child_start,
                child_count=child_count, leaf_order=leaf_order,
                node_lo=node_lo, node_hi=node_hi, depth=int(depth[0]))


def csg_boolean(op_code, tris_a, tris_b):
    """(n,3,3) f64 output triangle soup, or None without the library.
    op_code: 0=union, 1=subtraction, 2=intersection."""
    lib = native()
    if lib is None:
        return None
    tris_a = np.ascontiguousarray(tris_a, dtype=np.float64)
    tris_b = np.ascontiguousarray(tris_b, dtype=np.float64)
    n = lib.csg_boolean(op_code,
                        _ptr(tris_a, ctypes.c_double), len(tris_a),
                        _ptr(tris_b, ctypes.c_double), len(tris_b))
    out = np.empty((n, 3, 3), dtype=np.float64)
    lib.csg_fetch(_ptr(out, ctypes.c_double))
    return out

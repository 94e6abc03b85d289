"""Build the port's CUDA sources on first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` of this package into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes) under ``chroma_tpu_torch/_build/``.  Kernels take
raw device pointers and PyTorch's current CUDA stream; each C entry
point returns the ``cudaError_t`` of its launch.

Nothing is built when a module is imported: ``library()`` builds on the
first call.  A failed build raises; there is no fallback.
"""
import ctypes
import functools
import glob
import hashlib
import os
import subprocess

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(PKG_DIR, '_build')

# Hopper only.  --fmad=false keeps a*b+c as two roundings, as the plain
# PyTorch versions compute it, so kernel and plain version agree bit for
# bit.  -ftz/-prec-* pin IEEE behaviour; --use_fast_math must never be
# added: it flushes subnormals and approximates 1/x, and the slab test
# relies on 1/0 = inf for axis-parallel rays.
NVCC_FLAGS = (
    '-gencode=arch=compute_90a,code=sm_90a',
    '-std=c++17',
    '-O3',
    '--fmad=false',
    '-ftz=false',
    '-prec-div=true',
    '-prec-sqrt=true',
    '-Xptxas=-v',
    '-shared',
    '-Xcompiler', '-fPIC',
)


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, '*.cu')))


def nvcc_path():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError('no CUDA toolkit found (CUDA_HOME unset and no '
                           'nvcc on PATH); the CUDA kernels cannot be built')
    return os.path.join(CUDA_HOME, 'bin', 'nvcc')


def _digest(srcs):
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build():
    """Compile the sources (once per content hash).  Returns
    (library path, compiler log).  Raises on failure."""
    srcs = sources()
    if not srcs:
        raise RuntimeError('no CUDA sources under %s' % CSRC_DIR)
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, 'libchroma_tpu_torch_%s.so'
                       % _digest(srcs))
    if os.path.exists(out):
        return out, ''
    tmp = '%s.%d.tmp' % (out, os.getpid())
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed (%d):\n%s\n%s'
                           % (proc.returncode, ' '.join(cmd), log))
    os.replace(tmp, out)
    return out, log


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library with every entry point's ctypes
    signature declared."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mbvh_closest_hit.restype = i
    lib.mbvh_closest_hit.argtypes = [
        p, p, p, p, p, i,            # rows, org, dir, lht, active, n
        f, i, i, i,                  # sq, depth, instanced, max_iters
        p, p, p, p, p,               # triangle, distance, normal, mat, inc
        p]                           # stream
    return lib

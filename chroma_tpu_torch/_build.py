"""Build the port's CUDA sources on first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` of this package, one process per
source, all started together, and links the objects into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes) under ``chroma_tpu_torch/_build/``.  The library
is named by a digest of the flags and of every CUDA source and header
under ``csrc/``.  Kernels take raw device pointers and PyTorch's
current CUDA stream; each C entry point returns the ``cudaError_t`` of
its launch.

Nothing is built when a module is imported: ``library()`` builds on the
first call.  A failed build raises; there is no fallback.
"""
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(PKG_DIR, '_build')
# the shards of parallel.propagate_sharded call library() from one
# thread a device, and one process's build shares one work directory
_BUILD_LOCK = threading.Lock()

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


def _digest():
    """Digest of the flags and of every .cu and .cuh file under csrc/
    (name and content), so an edited header rebuilds too."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, '*.cu'))
                       + glob.glob(os.path.join(CSRC_DIR, '*.cuh'))):
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build():
    """Compile the sources (once per content hash).  Returns
    (library path, compiler log; the log of the build that made the
    library, kept beside it).  Raises on failure."""
    srcs = sources()
    if not srcs:
        raise RuntimeError('no CUDA sources under %s' % CSRC_DIR)
    digest = _digest()
    out = os.path.join(BUILD_DIR, 'libchroma_tpu_torch_%s.so' % digest)
    if os.path.exists(out):
        try:
            with open(out + '.log') as f:
                return out, f.read()
        except OSError:
            return out, ''
    work = os.path.join(BUILD_DIR, '%s.%d' % (digest, os.getpid()))
    os.makedirs(work, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for src in srcs:
        obj = os.path.join(work, os.path.basename(src) + '.o')
        cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = ''
    failed = []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log += '%s\n%s' % (' '.join(cmd), text)
        if proc.returncode != 0:
            failed.append(cmd[-1])
    if failed:
        raise RuntimeError('nvcc failed on %s:\n%s' % (failed, log))
    tmp = os.path.join(work, os.path.basename(out))
    cmd = [nvcc, '-shared', '-o', tmp, *[obj for _, obj, _ in jobs]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log += '%s\n%s%s' % (' '.join(cmd), proc.stdout, proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError('nvcc link failed (%d):\n%s'
                           % (proc.returncode, log))
    with open(tmp + '.log', 'w') as f:
        f.write(log)
    os.replace(tmp + '.log', out + '.log')
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    return out, log


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library with every entry point's ctypes
    signature declared."""
    with _BUILD_LOCK:
        path, _ = build()
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mbvh_closest_hit.restype = i
    lib.mbvh_closest_hit.argtypes = [
        p, p, p, p, p, i,            # rows, org, dir, lht, active, n
        f, i, i, i,                  # sq, depth, instanced, max_iters
        p, p, p, p, p,               # triangle, distance, normal, mat, inc
        p]                           # stream
    lib.mbvh_walk_window.restype = i
    lib.mbvh_walk_window.argtypes = [
        p, p, i, i,                  # rows, state pointers, nkeys, n
        f, i, i, i, i,               # sq, depth, instanced, od_slots, iters
        i, i, p,                     # rbase, rcount, root_lohi
        i, p,                        # prune, nactive counter (or null)
        p]                           # stream
    lib.mbvh_walk_window_k5.restype = i
    lib.mbvh_walk_window_k5.argtypes = [
        p, p, i, i,                  # rows, state pointers, nkeys, n
        f, i, i, i,                  # sq, depth, instanced, iters
        i, i,                        # prune, persistent blocks
        p, p,                        # queue word, nactive (or null)
        p]                           # stream
    lib.mbvh_walk_window_k5_grid.restype = i
    lib.mbvh_walk_window_k5_grid.argtypes = [
        i, ctypes.POINTER(i),        # instanced, blocks (out)
        ctypes.POINTER(i)]           # warps a block (out)
    lib.physics_step.restype = i
    lib.physics_step.argtypes = [
        p, i, i,                     # pointer slots, their count, n
        i, i, i, i, i,               # materials, wavelengths, components,
                                     # inverse-CDF nodes, surfaces
        i, f, f,                     # scatter_first, wavelength0, step
        i, i, i,                     # has_reemission, has_surfaces,
                                     # use_weights
        p]                           # stream
    return lib

"""The port's CSG (chroma_tpu_torch/csg.py and the CSG half of
csrc/host_native.cc) against the JAX package's.

Each backend is held against the same backend of the JAX package: the
native BSP booleans (C++) against the JAX package's native library, and
the Python BSP fallback against the JAX package's Python BSP.  The two
backends split polygons in a different order, so they are never compared
with each other.  Tolerance: none; triangles and vertices bit-equal.
"""
import time

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax  # noqa: F401  (imported before torch, as the test files do)
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import csg as jcsg
from chroma_tpu import make as jmake
from chroma_tpu import native as jnative
from chroma_tpu_torch import csg as pcsg
from chroma_tpu_torch import make as pmake
from chroma_tpu_torch import native as pnative
from chroma_tpu_torch.geometry import Mesh


def jax_native():
    """The JAX package's native library.  It is built in place in a
    cache directory that other test processes share, so a load can meet
    a half-written file: retry for a few seconds."""
    for _ in range(20):
        lib = jnative.native()
        if lib is not None:
            return lib
        jnative._tried = False
        time.sleep(0.5)
    return None


def shapes(make):
    """Closed, outward-wound meshes that overlap pairwise."""
    cube = make.cube(100.0)
    sphere = make.sphere(60.0, nsteps=10)
    sphere.vertices = sphere.vertices + np.array([40.0, 0.0, 0.0])
    cyl = make.cylinder(30.0, 160.0, nsteps=10)
    cyl.vertices = cyl.vertices + np.array([0.0, 0.0, 20.0])
    return {'cube': cube, 'sphere': sphere, 'cylinder': cyl}


PAIRS = [('cube', 'sphere'), ('cube', 'cylinder'), ('sphere', 'cylinder')]
OPS = ['union', 'subtraction', 'intersection']


def assert_meshes_equal(p, j):
    assert p.vertices.dtype == j.vertices.dtype
    assert p.triangles.dtype == j.triangles.dtype
    assert np.array_equal(p.vertices, j.vertices)
    assert np.array_equal(p.triangles, j.triangles)


def signed_volume(mesh):
    tv = mesh.vertices[mesh.triangles].astype(np.float64)
    return float(np.einsum('ij,ij->', tv[:, 0],
                           np.cross(tv[:, 1], tv[:, 2])) / 6.0)


@pytest.mark.parametrize('backend', ['native', 'python'])
@pytest.mark.parametrize('op', OPS)
@pytest.mark.parametrize('pair', PAIRS, ids=['-'.join(p) for p in PAIRS])
def test_boolean_matches_jax(pair, op, backend):
    pa, pb = (shapes(pmake)[k] for k in pair)
    ja, jb = (shapes(jmake)[k] for k in pair)
    assert_meshes_equal(pa, ja)
    if backend == 'native':
        assert pnative.native() is not None and jax_native() is not None
        got, want = pcsg.boolean(op, pa, pb), jcsg.boolean(op, ja, jb)
    else:
        got = pcsg._boolean_python(op, pa, pb)
        want = jcsg._boolean_python(op, ja, jb)
    assert isinstance(got, Mesh)
    assert len(got.triangles) > 0
    assert_meshes_equal(got, want)
    # the result is a solid: its volume lies within the inputs' bounds
    va, vb = signed_volume(pa), signed_volume(pb)
    v = signed_volume(got)
    if op == 'union':
        assert max(va, vb) - 1e-3 <= v <= va + vb + 1e-3
    elif op == 'subtraction':
        assert va - vb - 1e-3 <= v <= va + 1e-3
    else:
        assert 0.0 < v <= min(va, vb) + 1e-3


def test_boolean_wrappers_and_errors():
    a, b = (shapes(pmake)[k] for k in ('cube', 'sphere'))
    for fn, op in ((pcsg.union, 'union'), (pcsg.subtract, 'subtraction'),
                   (pcsg.intersect, 'intersection')):
        assert_meshes_equal(fn(a, b), pcsg.boolean(op, a, b))
    with pytest.raises(ValueError, match='unknown boolean op'):
        pcsg.boolean('xor', a, b)
    with pytest.raises(ValueError, match='unknown boolean op'):
        pcsg._boolean_python('xor', a, b)


def test_native_csg_falls_back_without_the_library(monkeypatch):
    """Without the native library ``boolean`` is the Python BSP, as in
    the JAX package (chroma_tpu/csg.py:211-230)."""
    a, b = (shapes(pmake)[k] for k in ('cube', 'cylinder'))
    monkeypatch.setattr(pnative, 'native', lambda: None)
    assert pnative.csg_boolean(1, a.vertices[a.triangles],
                               b.vertices[b.triangles]) is None
    assert_meshes_equal(pcsg.boolean('subtraction', a, b),
                        pcsg._boolean_python('subtraction', a, b))

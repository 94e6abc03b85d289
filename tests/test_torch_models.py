"""The port's demo models (chroma_tpu_torch/models) against the JAX
package's: each showpiece's mesh bit-equal (tolerance: none), the same
colors and materials, and each loadable as a ``@chroma_tpu_torch.models``
geometry string, as ``chroma-torch-cam`` loads it.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax  # noqa: F401  (imported before torch, as the test files do)
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import models as jmodels
from chroma_tpu_torch import loader as ploader
from chroma_tpu_torch import models as pmodels

MODELS = ['lionsolid', 'companioncube', 'liberty', 'tie_interceptor6']


def assert_solids_equal(p, j):
    for f in ('vertices', 'triangles'):
        a, b = getattr(p.mesh, f), getattr(j.mesh, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(p.color, j.color)
    for f in ('inner_material', 'outer_material'):
        assert [m.name for m in getattr(p, f)] \
            == [m.name for m in getattr(j, f)]
    assert list(p.surface) == list(j.surface) == [None] * len(p.surface)


@pytest.mark.parametrize('name', MODELS)
def test_model_matches_jax(name):
    p, j = getattr(pmodels, name)(), getattr(jmodels, name)()
    assert type(p).__module__ == 'chroma_tpu_torch.geometry'
    assert len(p.mesh.triangles) > 0
    assert_solids_equal(p, j)
    # a solid encloses a volume (the trefoil tube is wound inward in both
    # packages, so only its size is held)
    tv = p.mesh.vertices[p.mesh.triangles].astype(np.float64)
    volume = np.einsum('ij,ij->', tv[:, 0],
                       np.cross(tv[:, 1], tv[:, 2])) / 6.0
    assert abs(volume) > 1e6


def test_tube_along_curve_matches_jax():
    t = np.linspace(0, 2 * np.pi, 30, endpoint=False)
    points = np.column_stack([100 * np.cos(t), 100 * np.sin(t),
                              20 * np.sin(3 * t)])
    p = pmodels.tube_along_curve(points, radius=10.0, nsides=6)
    j = jmodels.tube_along_curve(points, radius=10.0, nsides=6)
    assert np.array_equal(p.vertices, j.vertices)
    assert np.array_equal(p.triangles, j.triangles)
    assert len(p.triangles) == 2 * 30 * 6


def test_model_loads_as_geometry_string(tmp_path, monkeypatch):
    """'@chroma_tpu_torch.models.lionsolid' becomes a flattened Geometry
    with a BVH, the trefoil's triangles and nothing else."""
    monkeypatch.setenv('CHROMA_TPU_CACHE', str(tmp_path))
    geo = ploader.load_geometry_from_string(
        '@chroma_tpu_torch.models.lionsolid')
    solid = pmodels.lionsolid()
    assert len(geo.mesh.triangles) == len(solid.mesh.triangles)
    assert geo.bvh is not None
    assert np.array_equal(np.unique(geo.colors), np.unique(solid.color))

"""Classic render-test scene: checkerboard floor + three spheres
(refractive, mirrored, lambertian).  (parity: chroma/demo/checkerboard.py,
rebuilt with vectorized checker assignment.)
"""
import numpy as np

from chroma_tpu_torch.geometry import Mesh, Solid, Geometry
from chroma_tpu_torch.make import sphere
from chroma_tpu_torch.demo.optics import (vacuum, water, black_surface,
                                    lambertian_surface, shiny_surface)


def build_checkerboard_scene(checkers_per_side=10, squares_per_checker=50):
    n = checkers_per_side * squares_per_checker
    coords = np.linspace(-5000.0, 5000.0, n + 1)
    xx, yy = np.meshgrid(coords, coords, indexing='ij')
    vertices = np.column_stack([xx.ravel(), yy.ravel(),
                                np.zeros(xx.size)])

    # two triangles per grid square, vectorized
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing='ij')
    v00 = (j * (n + 1) + i).ravel()
    v10 = ((j + 1) * (n + 1) + i).ravel()
    v11 = ((j + 1) * (n + 1) + i + 1).ravel()
    v01 = (j * (n + 1) + i + 1).ravel()
    triangles = np.concatenate([
        np.column_stack([v00, v10, v11]),
        np.column_stack([v00, v01, v11])]).reshape(2, -1, 3) \
        .transpose(1, 0, 2).reshape(-1, 3)

    mesh = Mesh(vertices, triangles, remove_duplicate_vertices=True)

    # checker parity of each triangle's square
    sq_i = np.repeat(i.ravel(), 2)
    sq_j = np.repeat(j.ravel(), 2)
    parity = ((sq_i // squares_per_checker)
              + (sq_j // squares_per_checker)) % 2 == 0

    color = np.where(parity, 0x000000, 0xffffff).astype(np.uint32)
    surface = np.where(parity, black_surface, lambertian_surface)

    checkerboard = Solid(mesh, vacuum, vacuum, surface=surface, color=color)

    sphere1 = Solid(sphere(1000.0, nsteps=512), water, vacuum)
    sphere2 = Solid(sphere(1000.0, nsteps=512), vacuum, vacuum,
                    surface=shiny_surface)
    sphere3 = Solid(sphere(1000.0, nsteps=512), vacuum, vacuum,
                    surface=lambertian_surface)

    scene = Geometry()
    scene.add_solid(checkerboard, displacement=(0, 0, -1500.0))
    scene.add_solid(sphere1, displacement=(2000.0, -2000.0, 0))
    scene.add_solid(sphere2, displacement=(-2000.0, -2000.0, 0))
    scene.add_solid(sphere3, displacement=(0.0, 2000.0, 0))
    return scene

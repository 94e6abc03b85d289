"""Rates of the main path (counterparts of chroma_tpu/benchmark.py:
ray intersections/s and photons propagated/s on a detector).

Every timed region ends in ``torch.cuda.synchronize()`` on a CUDA
device, so the host clock measures finished device work.
"""
import time

import numpy as np
import torch

from chroma_tpu_torch.event import Photons
from chroma_tpu_torch.sample import uniform_sphere
from chroma_tpu_torch.tools import argsort_direction
from chroma_tpu_torch import gpu
from chroma_tpu_torch.ops import mbvh as mbvh_ops


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _center_rays(nphotons, seed=0, sort=True):
    """Isotropic unit directions from the origin (numpy, seeded)."""
    rng = np.random.RandomState(seed)
    dirs = rng.normal(size=(nphotons, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1)[:, None]
    if sort:
        dirs = dirs[argsort_direction(dirs)]
    pos = np.zeros((nphotons, 3), dtype=np.float32)
    return pos, dirs


def _isotropic_photons(nphotons, seed=0, wavelength=400.0):
    pos, dirs = _center_rays(nphotons, seed)
    pol = np.cross(uniform_sphere(nphotons), dirs).astype(np.float32)
    pol /= np.linalg.norm(pol, axis=1)[:, None]
    return Photons(pos=pos, dir=dirs, pol=pol,
                   wavelengths=np.full(nphotons, wavelength, np.float32))


def intersect(gpu_geometry, number=10, nphotons=500000):
    """Ray intersections/s from the detector center (reference:
    chroma/benchmark.py:22), after one warm-up run."""
    dev = gpu_geometry.device
    pos, dirs = _center_rays(nphotons)
    o = torch.from_numpy(pos).to(dev)
    d = torch.from_numpy(dirs).to(dev)
    mbvh_ops.intersect_mesh(o, d, gpu_geometry.geom)
    run_times = []
    for _ in range(number):
        _sync(dev)
        t0 = time.time()
        mbvh_ops.intersect_mesh(o, d, gpu_geometry.geom)
        _sync(dev)
        run_times.append(time.time() - t0)
    return nphotons / np.array(run_times)


def propagate(gpu_geometry, number=10, nphotons=500000, max_steps=100,
              seed=1, **driver):
    """Full-physics photons propagated/s (reference:
    chroma/benchmark.py:70), after one warm-up run.  ``driver`` goes to
    ``GPUPhotons.propagate`` (``driver='steps'`` times the step loop,
    ``od_slots``, ``width``, ``service_every`` the on-deck driver).
    Returns (rates, photons of the last run)."""
    dev = gpu_geometry.device
    rng_states = gpu.get_rng_states(seed=seed, device=dev)
    photons = _isotropic_photons(nphotons)
    gpu.GPUPhotons(photons, dev).propagate(gpu_geometry, rng_states,
                                           max_steps=max_steps, **driver)
    run_times = []
    for _ in range(number):
        gp = gpu.GPUPhotons(photons, dev)
        _sync(dev)          # upload finished before the clock starts
        t0 = time.time()
        gp.propagate(gpu_geometry, rng_states, max_steps=max_steps,
                     **driver)
        _sync(dev)
        run_times.append(time.time() - t0)
    return nphotons / np.array(run_times), gp

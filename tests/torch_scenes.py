"""Small scenes for the port's step physics and one mixed batch of
``physics_update`` inputs.  Imports neither jax nor tests/conftest.py, so
the card tests (tests/test_torch_cuda.py) can use it.

* ``water_scene``: a 1,000 mm black sphere around one PMT cube in water;
* ``scint_scene``: the sphere filled with a scintillator of two
  reemitting components, each absorbing over 600 mm (300 mm together)
  and reemitting over 380-480 nm with probability 0.3 and 0.8;
* ``mixed_scene``: the water scene with a sphere that absorbs, detects,
  reflects diffusely and specularly and passes a fifth each, into glass,
  and a glass cube inside, so every DEFAULT-surface outcome and Fresnel
  refraction, reflection and total internal reflection occur.
"""
import numpy as np
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.ops import mbvh
from chroma_tpu_torch.ops.propagate import (
    NDRAWS, U_ABSORB, U_SCATTER, U_SPHERE1B, U_SPHERE2B, alive_mask, i32,
    make_photon_state)


def _water_detector(sphere_surface, outer=None, cube=None):
    from chroma_tpu_torch import make
    from chroma_tpu_torch.demo import optics
    from chroma_tpu_torch.detector import Detector
    from chroma_tpu_torch.geometry import Solid
    det = Detector(optics.water)
    det.add_solid(Solid(make.sphere(1000.0, nsteps=24), optics.water,
                        outer or optics.water, surface=sphere_surface))
    if cube is not None:
        det.add_solid(Solid(make.cube(200.0), cube, optics.water),
                      displacement=(0, -400.0, 0))
    det.add_pmt(Solid(make.cube(300.0), optics.water, optics.water,
                      surface=optics.r7081hqe_photocathode),
                displacement=(0, 0, 500.0))
    det.set_time_dist_gaussian(1.5, -7.5, 7.5)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.0, 1.5)
    det.flatten()
    return det


def water_scene():
    from chroma_tpu_torch.demo import optics
    return _water_detector(optics.black_surface)


def scint_scene():
    from chroma_tpu_torch import make
    from chroma_tpu_torch.demo import optics
    from chroma_tpu_torch.detector import Detector
    from chroma_tpu_torch.geometry import Material, Solid
    x = np.arange(60.0, 1000.0, 5.0)
    scint = Material('scint')
    scint.set('refractive_index', 1.5)
    scint.set('absorption_length', 300.0)
    scint.set('scattering_length', 1e6)
    cdf = np.clip((x - 380.0) / 100.0, 0.0, 1.0)
    for prob in (0.3, 0.8):
        scint.add_reemission_component(
            reemission_prob=np.column_stack([x, np.full_like(x, prob)]),
            wvl_cdf=np.column_stack([x, cdf]),
            absorption_length=np.column_stack([x, np.full_like(x, 600.0)]))
    det = Detector(scint)
    det.add_solid(Solid(make.sphere(1000.0, nsteps=24), scint,
                        optics.water, surface=optics.black_surface))
    det.add_pmt(Solid(make.cube(300.0), scint, scint,
                      surface=optics.r7081hqe_photocathode),
                displacement=(0, 0, 500.0))
    det.flatten()
    return det


def mixed_scene():
    from chroma_tpu_torch.demo import optics
    from chroma_tpu_torch.geometry import Surface
    mixed = Surface('mixed')
    for name in ('absorb', 'detect', 'reflect_diffuse', 'reflect_specular'):
        mixed.set(name, 0.2)
    return _water_detector(mixed, outer=optics.glass, cube=optics.glass)


SCENES = {'water': water_scene, 'scint': scint_scene, 'mixed': mixed_scene}
# a draw just below 1: the interaction it feeds happens within microns
NEAR_ONE = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def physics_inputs(tables, n, seed, device):
    """``physics_update``'s arguments (state, res, tables, u, flags,
    active, nan_mask) as ``propagate_step`` hands them over, for ``n``
    photons around the sphere's centre, mixing every case a step meets:
    photons dead before the step (a terminal flag), NaN-aborted (a NaN
    position), incomplete walks, and missing ones (no triangle) beside
    live hits; weights of 1 and below the weighting threshold;
    wavelengths on and off the tables' grid; a sixth of the photons with
    a scattering draw and another sixth with an absorption draw just
    below 1, so that scattering and absorption happen in every medium;
    draws of exactly 0 at the poles of ``uniform_sphere``."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-650.0, 650.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pol = np.cross(d, rng.normal(size=(n, 3)))
    pol /= np.linalg.norm(pol, axis=1, keepdims=True)
    wl = rng.uniform(300.0, 600.0, n)
    wl[rng.rand(n) < 0.02] = 40.0           # below the grid
    wl[rng.rand(n) < 0.02] = 1500.0         # above it
    weight = np.where(rng.rand(n) < 0.1, 5e-5, rng.uniform(0.2, 1.0, n))
    flags = np.where(rng.rand(n) < 0.2,
                     event.RAYLEIGH_SCATTER | event.REFLECT_DIFFUSE, 0)
    flags = np.where(rng.rand(n) < 0.1, flags | event.BULK_ABSORB, flags)
    pos[rng.rand(n) < 0.03, 1] = np.nan
    state = make_photon_state(
        pos=pos, dir=d.astype(np.float32), pol=pol.astype(np.float32),
        wavelength=wl.astype(np.float32),
        t=rng.uniform(0.0, 10.0, n).astype(np.float32),
        weight=weight.astype(np.float32), flags=flags.astype(np.int32),
        evidx=rng.randint(0, 4, n).astype(np.int32), device=device)
    alive0 = alive_mask(state['flags'])
    bad = torch.isnan(state['dir'].sum(dim=1) + state['pos'].sum(dim=1))
    nan_mask = alive0 & bad
    flags = torch.where(nan_mask,
                        state['flags'] | i32(event.NO_HIT | event.NAN_ABORT),
                        state['flags'])
    active = alive0 & ~bad
    res = mbvh.intersect_mesh(state['pos'], state['dir'], tables,
                              state['last_hit_triangle'], active=active)
    # a last-hit triangle on some photons, the walk cut on others, and
    # some walks that found nothing
    state['last_hit_triangle'] = torch.where(
        torch.from_numpy(rng.rand(n) < 0.3).to(device), res['triangle'],
        state['last_hit_triangle'])
    res['incomplete'] = res['incomplete'] | torch.from_numpy(
        rng.rand(n) < 0.03).to(device)
    res['triangle'] = torch.where(torch.from_numpy(rng.rand(n) < 0.05)
                                  .to(device), -1, res['triangle'])

    u = rng.rand(n, NDRAWS).astype(np.float32)
    pick = rng.randint(0, 6, n)
    u[pick == 0, U_SCATTER] = NEAR_ONE
    u[pick == 1, U_ABSORB] = NEAR_ONE
    u[rng.rand(n) < 0.02, U_SPHERE1B] = 0.0
    u[rng.rand(n) < 0.02, U_SPHERE2B] = 0.0
    return (state, res, tables, torch.from_numpy(u).to(device), flags,
            active, nan_mask)

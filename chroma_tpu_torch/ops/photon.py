"""Photon batches on the device and the propagation step loop.

Counterpart of chroma_tpu/ops/photon.py.  The driver is a host loop of
``propagate_step`` over the photons still alive: dead photons drop out
of the working set, and every step draws one full (n, NDRAWS) block of
uniforms in which each live photon reads the row of its original
``index``, so the pairing of photons and draws does not depend on which
photons are still alive.
"""
import numpy as np
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.ops.propagate import (NDRAWS, alive_mask,
                                            make_photon_state,
                                            propagate_step)


def upload_photons(photons, device):
    """event.Photons -> SoA state dict on ``device``."""
    return make_photon_state(
        pos=photons.pos, dir=photons.dir, pol=photons.pol,
        wavelength=photons.wavelengths, t=photons.t,
        weight=photons.weights,
        flags=np.asarray(photons.flags, np.uint32).view(np.int32),
        last_hit_triangle=photons.last_hit_triangles,
        evidx=np.asarray(photons.evidx, np.uint32).view(np.int32),
        device=device)


def download_photons(state):
    """SoA state dict -> event.Photons (flags and evidx back
    to uint32)."""
    def get(k):
        return state[k].cpu().numpy()
    return event.Photons(
        pos=get('pos'), dir=get('dir'), pol=get('pol'),
        wavelengths=get('wavelength'), t=get('t'),
        last_hit_triangles=get('last_hit_triangle'),
        flags=get('flags').view(np.uint32),
        weights=get('weight'), evidx=get('evidx').view(np.uint32))


def unsort_photons(state):
    """Restore original order from the carried ``index`` field."""
    order = torch.empty_like(state['index'])
    order[state['index']] = torch.arange(len(order), device=order.device)
    return {k: v[order] for k, v in state.items()}


def uniform_draws(generator, n):
    """A draw source for ``propagate``: each call returns a fresh
    (n, NDRAWS) block of uniforms from ``generator``."""
    def draw():
        return torch.rand((n, NDRAWS), generator=generator,
                          device=generator.device)
    return draw


def propagate(state, tables, draws, max_steps=100, scatter_first=0,
              use_weights=False):
    """Propagate all photons to termination or ``max_steps``.

    ``draws()`` returns the next (n, NDRAWS) draw block; it is called
    once per step.  ``scatter_first`` (+1 force / -1 forbid) applies on
    step 0 only, as in the reference; ``use_weights`` is
    ``physics_update``'s.  Returns (state, steps).
    """
    state = dict(state)
    steps = 0
    while steps < max_steps:
        live = torch.nonzero(alive_mask(state['flags'])).squeeze(1)
        if live.numel() == 0:
            break
        u = draws()[state['index'][live]]
        sub = {k: v[live] for k, v in state.items()}
        sub = propagate_step(sub, tables, u,
                             scatter_first if steps == 0 else 0,
                             use_weights=use_weights)
        for k, v in sub.items():
            state[k] = state[k].index_copy(0, live, v)
        steps += 1
    return state, steps

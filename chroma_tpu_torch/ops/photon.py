"""Photon batches on the device, the propagation step loop and the
compacting driver.

Counterpart of chroma_tpu/ops/photon.py.  ``propagate`` is a host loop
of ``propagate_step`` over the photons still alive: dead photons drop
out of the working set, and every step draws one full (n, NDRAWS) block
of uniforms in which each live photon reads the row of its original
``index``, so the pairing of photons and draws does not depend on which
photons are still alive, nor on their order.  ``sort_every`` reorders
the batch by a Morton key of position (``sort_photons``) so that rays
walked together start near each other; ``propagate_compacting`` runs
rounds of steps on the smallest power-of-two prefix that holds the live
photons (``partition_photons``).  By the draw rule both give the
photons the step loop gives, bit for bit, once put back in order
(``unsort_photons``).
"""
import numpy as np
import torch

from chroma_tpu_torch import event, tracing
from chroma_tpu_torch.ops.propagate import (NDRAWS, TERMINAL, alive_mask,
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


def _morton_key(state, world_origin, inv_extent):
    """30-bit Morton key of position in the world box (10 bits an axis,
    x lowest), int64 because torch on the CPU cannot right-shift uint32;
    terminated photons get 0xFFFFFFFF, after every live one."""
    q = torch.clamp((state['pos'] - world_origin) * inv_extent, 0.0, 1.0)
    q = (q * 1023.0).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    key = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    dead = (state['flags'] & TERMINAL) != 0
    return torch.where(dead, 0xFFFFFFFF, key)


def _world_box(tables):
    """(world origin, 1 / extent) of the MBVH world box, float32, as
    the JAX driver computes them."""
    return tables.world_origin, 1.0 / (tables.world_scale * 65535.0)


def sort_photons(state, world_origin, inv_extent):
    """The batch in Morton order (a stable sort), dead photons last.
    Returns (state, order)."""
    order = torch.argsort(_morton_key(state, world_origin, inv_extent),
                          stable=True)
    return {k: v[order] for k, v in state.items()}, order


def partition_photons(state):
    """Stable partition: live photons first, dead photons last.  Returns
    (state, order)."""
    alive = alive_mask(state['flags']).to(torch.int64)
    n = alive.shape[0]
    cnt = torch.cumsum(alive, 0)
    dead_rank = torch.cumsum(1 - alive, 0) - 1
    dest = torch.where(alive != 0, cnt - 1, cnt[-1] + dead_rank)
    order = torch.empty_like(dest)
    order[dest] = torch.arange(n, device=dest.device)
    return {k: v[order] for k, v in state.items()}, order


def uniform_draws(generator, n):
    """A draw source for ``propagate``: each call returns a fresh
    (n, NDRAWS) block of uniforms from ``generator``."""
    def draw():
        return torch.rand((n, NDRAWS), generator=generator,
                          device=generator.device)
    return draw


def propagate(state, tables, draws, max_steps=100, scatter_first=0,
              use_weights=False, sort_every=0):
    """Propagate all photons to termination or ``max_steps``.

    ``draws()`` returns the next (n, NDRAWS) draw block; it is called
    once per step.  ``scatter_first`` (+1 force / -1 forbid) applies on
    step 0 only, as in the reference; ``use_weights`` is
    ``physics_update``'s.  ``sort_every`` k > 0 puts the batch in Morton
    order (``sort_photons``) before every k-th step; the state then
    comes back in that order, as the JAX driver's does
    (``unsort_photons`` restores it).  Returns (state, steps).
    """
    state = dict(state)
    steps = 0
    if sort_every:
        box = _world_box(tables)
    while steps < max_steps:
        if sort_every and steps % sort_every == 0:
            state, _ = sort_photons(state, *box)
        with tracing.span('step.live'):     # waits for the last step
            live = torch.nonzero(alive_mask(state['flags'])).squeeze(1)
        if live.numel() == 0:
            break
        tracing.count('step.live_photons', live.numel())
        with tracing.span('step.draw'):
            u = draws()[state['index'][live]]
        with tracing.span('step.gather'):
            sub = {k: v[live] for k, v in state.items()}
        sub = propagate_step(sub, tables, u,
                             scatter_first if steps == 0 else 0,
                             use_weights=use_weights)
        with tracing.span('step.scatter'):
            for k, v in sub.items():
                state[k] = state[k].index_copy(0, live, v)
        steps += 1
    return state, steps


def _next_pow2(n):
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def propagate_compacting(state, tables, draws, max_steps=100,
                         use_weights=False, scatter_first=0,
                         steps_per_round=1, min_bucket=8192,
                         trickle_rounds=96):
    """Host-driven wavefront propagation with live-photon compaction.

    Each round partitions the batch so the live photons form a prefix
    (``partition_photons``) and runs ``steps_per_round`` steps of
    ``propagate`` on the smallest power-of-two prefix that holds them
    (at least 256 photons); once that prefix is at most ``min_bucket``,
    a round runs up to ``trickle_rounds`` steps, ending early when its
    photons are all dead.  ``draws()`` returns (n, NDRAWS) blocks for
    the whole batch; a photon reads the row of its ``index``, which
    must be 0..n-1.  Returns (state in the caller's order, steps)."""
    n = state['pos'].shape[0]
    total_steps = 0
    first = True
    bucket = n
    while total_steps < max_steps:
        if not first:
            state, _ = partition_photons(state)
            alive = int(alive_mask(state['flags']).sum())
            if alive == 0:
                break
            bucket = min(_next_pow2(max(alive, 256)), n)
        rounds = min(trickle_rounds if bucket <= min_bucket
                     else steps_per_round, max_steps - total_steps)
        sub = {k: v[:bucket] for k, v in state.items()}
        sub, _ = propagate(sub, tables, draws, max_steps=rounds,
                           scatter_first=scatter_first if first else 0,
                           use_weights=use_weights)
        state = sub if bucket == n else {
            k: torch.cat([sub[k], v[bucket:]]) for k, v in state.items()}
        total_steps += rounds
        first = False
    return unsort_photons(state), total_steps

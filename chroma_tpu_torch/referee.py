"""Referee check 1 of chroma_tpu/referee.py for the port: terminal
passthrough.

Photons that are terminal on arrival must leave ``propagate_fused``
with every word bit-exact: denormal floats, NaN payloads in pos/dir and
every flag bit.  A float select or a flush-to-zero anywhere in the
driver's pack, retire or unpack plumbing corrupts them.
"""
import numpy as np
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.ops import fused


def adversarial_terminal_state(n, seed=3):
    """chroma_tpu/referee.py ``_adversarial_terminal_state`` in numpy:
    the same bit patterns, with flags and evidx as int32 holding the
    uint32 bits (the port's photon state dtypes)."""
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 1 << 31, size=(n, 16), dtype=np.int64) \
        .astype(np.uint32)
    bits = bits * np.uint32(2) + (np.arange(n)[:, None] & 1).astype(
        np.uint32)
    pos = bits[:, 0:3].view(np.float32).copy()
    dirv = bits[:, 3:6].view(np.float32).copy()
    pol = bits[:, 6:9].view(np.float32).copy()
    pos[::7, 0] = np.float32(1.4e-45)
    pos[1::7, 1] = np.uint32(0x007fffff).view(np.float32)
    dirv[2::7, 2] = np.float32(np.nan)
    flags = (bits[:, 12] | np.uint32(event.BULK_ABSORB)).astype(np.uint32)
    flags[::3] |= np.uint32(event.SURFACE_DETECT)
    return dict(
        pos=pos, dir=dirv, pol=pol,
        wavelength=bits[:, 9].view(np.float32).copy(),
        t=bits[:, 10].view(np.float32).copy(),
        weight=np.full(n, np.uint32(1)).view(np.float32).copy(),
        flags=flags.view(np.int32),
        last_hit_triangle=bits[:, 13].view(np.int32).copy(),
        evidx=(bits[:, 14] >> np.uint32(8)).view(np.int32),
        index=np.arange(n, dtype=np.int64))


def terminal_passthrough(tables, n=4096, width=1024, service_every=4,
                         od_slots=1):
    """Run the adversarial state through ``propagate_fused`` on the
    tables' device.  Returns the names of the fields that did not come
    back bit-exact (empty when the check passes)."""
    dev = tables.mbvh_rows.device
    ref = adversarial_terminal_state(n)
    state = {k: torch.from_numpy(v).to(dev) for k, v in ref.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out, _ = fused.propagate_fused(
        state, tables, fused.uniform_draws(gen), max_steps=10, width=width,
        service_every=service_every, od_slots=od_slots)
    bad = []
    for k, v in ref.items():
        got = np.ascontiguousarray(out[k].cpu().numpy())
        if got.dtype != v.dtype or not np.array_equal(
                got.view(np.uint8), v.view(np.uint8)):
            bad.append(k)
    return bad

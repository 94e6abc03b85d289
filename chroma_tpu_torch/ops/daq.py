"""DAQ: digitize detected photons into per-channel (time, charge, flags).

Counterpart of chroma_tpu/ops/daq.py (reference: chroma/cuda/daq.cu).
Segment reductions with ``scatter_reduce``: the earliest hit time by
``amin``, the quantized charge by an integer ``sum`` and the history
word by a per-bit ``amax``.  Minima, integer sums and maxima do not
depend on the order of the scatter, so the result is exact.
"""
import numpy as np
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.ops.geometry_pack import sample_icdf
from chroma_tpu_torch.ops.propagate import i32

# bits that can appear in a photon history word
_HISTORY_BITS = tuple(range(12)) + (31,)


def daq_draws(generator, ndaq, n):
    """The (3, ndaq, n) uniform block ``run_daq`` consumes."""
    return torch.rand((3, ndaq, n), generator=generator,
                      device=generator.device)


def run_daq(state, tables, det, u, nchannels, ndaq=1, nevents=1,
            global_weight=1.0, detection_state=event.SURFACE_DETECT):
    """One DAQ acquisition over a propagated photon batch, with the draw
    block ``u`` (3, ndaq, n).

    Returns dict(t, q, flags), each (nevents*ndaq*nchannels,), with unhit
    channels at t = 1e9; ``flags`` is int32 with the uint32 bits.
    Photons accumulate into per-event channel blocks by ``evidx``;
    photons with evidx outside [0, nevents) are dropped.
    """
    dev = state['pos'].device
    n = state['pos'].shape[0]
    tri = state['last_hit_triangle']
    flags = state['flags']

    solid = tables.solid_id_map[torch.clamp(tri, min=0)]
    channel = det.solid_id_to_channel_index[solid]
    evidx = state['evidx']
    detected = (tri >= 0) & ((flags & i32(detection_state)) != 0) \
        & (channel >= 0) & (evidx >= 0) & (evidx < nevents)

    weight = state['weight'] * global_weight
    keep = detected[None, :] & (u[0] < weight[None, :])
    t_smear = sample_icdf(det.time_icdf, u[1].reshape(-1)).reshape(ndaq, n)
    times = state['t'][None, :] + t_smear
    charge = sample_icdf(det.charge_icdf, u[2].reshape(-1)).reshape(ndaq, n)
    # float -> unsigned saturates at 0, as XLA converts
    q_int = torch.clamp(torch.round(charge / det.charge_unit), min=0.0) \
        .to(torch.int64)

    total = nchannels * ndaq * nevents
    slot = channel[None, :].to(torch.int64) + nchannels * (
        torch.arange(ndaq, device=dev)[:, None]
        + ndaq * evidx[None, :].to(torch.int64))
    slot = torch.where(keep, slot, total).reshape(-1)   # total = dropped
    times = torch.where(keep, times, 1e9).reshape(-1)
    q_int = torch.where(keep, q_int, 0).reshape(-1)

    earliest = torch.full((total + 1,), 1e9, dtype=torch.float32,
                          device=dev).scatter_reduce(0, slot, times, 'amin')
    q_sum = torch.zeros(total + 1, dtype=torch.int64,
                        device=dev).scatter_reduce(0, slot, q_int, 'sum')

    hist = torch.zeros(total, dtype=torch.int32, device=dev)
    ph_flags = flags[None, :].expand(ndaq, n).reshape(-1)
    for b in _HISTORY_BITS:
        bit = (ph_flags >> b) & 1
        got = torch.zeros(total + 1, dtype=torch.int32,
                          device=dev).scatter_reduce(0, slot, bit, 'amax')
        hist = hist | (got[:total] << b)

    q = (q_sum[:total] & 0xFFFFFFFF).to(torch.float32) * det.charge_unit
    return dict(t=earliest[:total], q=q, flags=hist)


class GPUChannels(object):
    """Channel readout buffers (parity: chroma/gpu/daq.py GPUChannels)."""

    def __init__(self, t, q, flags, ndaq=1, stride=None):
        self.t = t
        self.q = q
        self.flags = flags
        self.ndaq = ndaq
        self.stride = stride if stride is not None else len(t) // ndaq

    def iterate_copies(self):
        for i in range(self.ndaq):
            sl = slice(i * self.stride, (i + 1) * self.stride)
            yield GPUChannels(self.t[sl], self.q[sl], self.flags[sl])

    def get(self):
        """Download as an event.Channels; channels with t < 1e8 are hit."""
        t = self.t.cpu().numpy()
        q = self.q.cpu().numpy()
        flags = self.flags.cpu().numpy().view(np.uint32)
        return event.Channels(t < 1e8, t, q, flags)

    def __len__(self):
        return self.t.numel()


class GPUDaq(object):
    """DAQ driver (parity: chroma/gpu/daq.py GPUDaq)."""

    def __init__(self, gpu_detector, ndaq=1):
        self.geom = gpu_detector.geom
        self.det = gpu_detector.det
        self.nchannels = gpu_detector.det.nchannels
        self.ndaq = ndaq
        self.stride = self.nchannels
        self._acc = None

    def begin_acquire(self, *args, **kwargs):
        self._acc = None

    def acquire(self, photons, rng_states, weight=1.0, **ignored):
        """Digitize a GPUPhotons (or a state dict), drawing from the
        ``torch.Generator`` of ``rng_states`` (an RNGStream or a
        Generator)."""
        state = photons.state if hasattr(photons, 'state') else photons
        generator = getattr(rng_states, 'generator', rng_states)
        u = daq_draws(generator, self.ndaq, state['pos'].shape[0])
        res = run_daq(state, self.geom, self.det, u, self.nchannels,
                      ndaq=self.ndaq, global_weight=weight)
        if self._acc is None:
            self._acc = res
        else:
            self._acc = dict(t=torch.minimum(self._acc['t'], res['t']),
                             q=self._acc['q'] + res['q'],
                             flags=self._acc['flags'] | res['flags'])
        return self._acc

    def end_acquire(self, *args, **kwargs):
        res = self._acc
        if res is None:
            dev = self.geom.mbvh_rows.device
            total = self.nchannels * self.ndaq
            res = dict(t=torch.full((total,), 1e9, device=dev),
                       q=torch.zeros(total, device=dev),
                       flags=torch.zeros(total, dtype=torch.int32,
                                         device=dev))
        return GPUChannels(res['t'], res['q'], res['flags'], self.ndaq,
                           self.stride)

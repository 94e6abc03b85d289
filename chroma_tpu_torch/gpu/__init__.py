"""Device-runtime layer: GPUGeometry, GPUDetector, GPUPhotons, RNGStream.

Counterpart of chroma_tpu/gpu/__init__.py (reference: chroma/gpu/*),
with the same class names and call shapes.  Every class takes a
``device``; its default, ``default_device()``, is the CUDA card, and
where there is none the constructors raise: the CPU is used only when
the caller names it.  Photon batches are not padded: the
JAX package pads to powers of two for XLA's compile cache, which eager
PyTorch does not need.
"""
import numpy as np
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.ops.geometry_pack import pack_geometry, pack_detector
from chroma_tpu_torch.ops import fused as fused_ops
from chroma_tpu_torch.ops import photon as photon_ops
from chroma_tpu_torch.ops.daq import GPUDaq, GPUChannels, run_daq
from chroma_tpu_torch.ops.propagate import i32

__all__ = ['GPUGeometry', 'GPUDetector', 'GPUPhotons', 'GPUDaq',
           'GPUChannels', 'RNGStream', 'get_rng_states', 'default_device',
           'run_daq']


def default_device():
    """The CUDA card; raises where there is none (pass ``device='cpu'``
    to run the plain PyTorch versions on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            'chroma_tpu_torch: no CUDA device is available; pass '
            "device='cpu' to run on the CPU")
    return torch.device('cuda')


def _device(device):
    return torch.device(device if device is not None else default_device())


class RNGStream(object):
    """A seeded ``torch.Generator`` on the device (replaces the
    reference's per-thread curand states)."""

    def __init__(self, seed=0, device=None):
        device = _device(device)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed))


def get_rng_states(size=None, seed=1, device=None):
    """API-compatible RNG construction; ``size`` is ignored."""
    return RNGStream(seed, device)


class GPUGeometry(object):
    """Packed device geometry (reference: chroma/gpu/geometry.py)."""

    def __init__(self, geometry, device=None, wavelengths=None, times=None):
        self.device = _device(device)
        self.geometry = geometry
        self.geom = pack_geometry(geometry, self.device,
                                  wavelengths=wavelengths, times=times)
        self.det = None
        self.solid_id_map = self.geom.solid_id_map


class GPUDetector(GPUGeometry):
    """Geometry + channel maps + readout CDFs (reference:
    chroma/gpu/detector.py)."""

    def __init__(self, detector, device=None, wavelengths=None, times=None):
        self.device = _device(device)
        self.geometry = detector
        self.geom, self.det = pack_detector(detector, self.device,
                                            wavelengths=wavelengths,
                                            times=times)
        self.solid_id_map = self.geom.solid_id_map
        self.nchannels = self.det.nchannels

    @classmethod
    def from_table_cache(cls, name, detector=None, device=None):
        """Construct from the packed-table cache (shared with the JAX
        package); returns None on a miss.  ``save_table_cache`` fills
        it."""
        from chroma_tpu_torch.ops.table_cache import load_tables
        device = _device(device)
        hit = load_tables(name, device)
        if hit is None:
            return None
        self = object.__new__(cls)
        self.device = device
        self.geometry = detector
        self.geom, self.det = hit
        self.solid_id_map = self.geom.solid_id_map
        self.nchannels = self.det.nchannels if self.det else 0
        return self

    def save_table_cache(self, name):
        from chroma_tpu_torch.ops.table_cache import save_tables
        save_tables(name, self.geom, self.det)


class GPUPhotons(object):
    """Device photon batch (reference: chroma/gpu/photon.py GPUPhotons).

    ``ncopies > 1`` replicates the photons for likelihood evaluation."""

    def __init__(self, photons, device=None, ncopies=1, copy_flags=True,
                 copy_triangles=True, copy_weights=True):
        device = _device(device)
        state = photon_ops.upload_photons(photons, device)
        if not copy_flags:
            state['flags'] = torch.zeros_like(state['flags'])
        if not copy_triangles:
            state['last_hit_triangle'] = \
                torch.full_like(state['last_hit_triangle'], -1)
        if not copy_weights:
            state['weight'] = torch.ones_like(state['weight'])
        if ncopies > 1:
            state = {k: v.repeat((ncopies,) + (1,) * (v.dim() - 1))
                     for k, v in state.items()}
        state['index'] = torch.arange(state['pos'].shape[0], device=device)
        self._init(state, len(photons), len(photons), ncopies)

    def _init(self, state, true_nphotons, stride, ncopies):
        self.state = state
        self.true_nphotons = true_nphotons
        self.stride = stride
        self.ncopies = ncopies
        self.last_steps = None
        self.last_stats = None

    @classmethod
    def _from_state(cls, state, true_nphotons, stride=None, ncopies=1):
        self = object.__new__(cls)
        self._init(state, true_nphotons,
                   true_nphotons if stride is None else stride, ncopies)
        return self

    def __len__(self):
        return self.state['pos'].shape[0]

    @property
    def pos(self):
        return self.state['pos']

    def propagate(self, gpu_geometry, rng_states, max_steps=100,
                  scatter_first=0, driver='fused', width=None,
                  service_every=None, od_slots=1):
        """Propagate every photon to termination or ``max_steps``
        (reference gpu/photon.py:192), drawing from the generator of
        ``rng_states``.

        ``driver='fused'`` (the default, as in the JAX package) runs the
        on-deck lane-pool driver ops/fused.propagate_fused with
        ``width``, ``service_every`` and ``od_slots`` and keeps its
        int32[4] stats [service passes, photon-steps, lane-iterations,
        0] in ``last_stats``.  ``driver='steps'`` runs the step loop
        ops/photon.propagate and keeps its step count in
        ``last_steps``."""
        geom = gpu_geometry.geom
        if driver == 'fused':
            self.state, stats = fused_ops.propagate_fused(
                self.state, geom, fused_ops.uniform_draws(
                    rng_states.generator),
                max_steps=max_steps, width=width,
                service_every=service_every or fused_ops.SERVICE_EVERY,
                od_slots=od_slots, scatter_first=scatter_first)
            self.last_stats = stats.cpu().numpy()
            self.last_steps = None
        elif driver == 'steps':
            draws = photon_ops.uniform_draws(rng_states.generator,
                                             len(self))
            self.state, self.last_steps = photon_ops.propagate(
                self.state, geom, draws, max_steps=max_steps,
                scatter_first=scatter_first)
            self.last_stats = None
        else:
            raise ValueError("driver must be 'fused' or 'steps', got %r"
                             % (driver,))

    def get(self):
        """Download as Photons (copies concatenated)."""
        return photon_ops.download_photons(self.state)

    def select(self, target_flag, start_photon=None, nphotons=None):
        """New GPUPhotons with the photons that carry ``target_flag``
        (reference gpu/photon.py select)."""
        start = start_photon or 0
        stop = None if nphotons is None else start + nphotons
        flags = self.state['flags'][start:stop]
        idx = torch.nonzero((flags & i32(target_flag)) != 0).squeeze(1)
        state = {k: v[start:stop][idx] for k, v in self.state.items()}
        state['index'] = torch.arange(len(idx), device=idx.device)
        return GPUPhotons._from_state(state, len(idx))

    def iterate_copies(self):
        for i in range(self.ncopies):
            sl = slice(i * self.stride, (i + 1) * self.stride)
            yield GPUPhotons._from_state(
                {k: v[sl] for k, v in self.state.items()},
                self.true_nphotons)

    def get_flat_hits(self, gpu_detector, target_flag=event.SURFACE_DETECT,
                      no_map=False, **ignored):
        """Photons that terminated on a detecting channel, with their
        channel index (reference gpu/photon.py get_flat_hits)."""
        state = self.state
        tri = state['last_hit_triangle']
        solid = gpu_detector.geom.solid_id_map[torch.clamp(tri, min=0)]
        channel = gpu_detector.det.solid_id_to_channel_index[solid]
        keep = (tri >= 0) & ((state['flags'] & i32(target_flag)) != 0) \
            & (channel >= 0)
        idx = torch.nonzero(keep).squeeze(1)
        photons = photon_ops.download_photons(
            {k: v[idx] for k, v in state.items()})
        photons.channel = channel[idx].cpu().numpy().astype(np.uint32)
        return photons

    def get_hits(self, gpu_detector, **kwargs):
        flat = self.get_flat_hits(gpu_detector, **kwargs)
        return {int(c): flat[flat.channel == c]
                for c in np.unique(flat.channel)}

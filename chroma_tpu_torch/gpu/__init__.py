"""Device-runtime layer: GPUGeometry, GPUDetector, GPUPhotons, RNGStream.

Counterpart of chroma_tpu/gpu/__init__.py (reference: chroma/gpu/*),
with the same class names and call shapes.  Every class takes a
``device``; its default, ``default_device()``, is the CUDA card, and
where there is none the constructors raise: the CPU is used only when
the caller names it.  Photon batches are not padded: the
JAX package pads to powers of two for XLA's compile cache, which eager
PyTorch does not need.  ``GPUPhotons.propagate(mesh=...)`` shards a
batch over several devices (``chroma_tpu_torch.parallel``).
"""
import dataclasses

import numpy as np
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.device import default_device, resolve as _device
from chroma_tpu_torch.ops.geometry_pack import pack_geometry, pack_detector
from chroma_tpu_torch import parallel
from chroma_tpu_torch.ops import fused as fused_ops
from chroma_tpu_torch.ops import photon as photon_ops
from chroma_tpu_torch.ops.daq import GPUDaq, GPUChannels, run_daq
from chroma_tpu_torch.ops.pdf import GPUPDF, GPUKernelPDF
from chroma_tpu_torch.ops.propagate import alive_mask, i32, propagate_step

__all__ = ['GPUGeometry', 'GPUDetector', 'GPUPhotons', 'GPUDaq',
           'GPUChannels', 'GPUPDF', 'GPUKernelPDF', 'RNGStream',
           'create_cuda_context', 'get_rng_states', 'default_device',
           'run_daq']


class RNGStream(object):
    """A seeded ``torch.Generator`` on the device (replaces the
    reference's per-thread curand states)."""

    def __init__(self, seed=0, device=None):
        device = _device(device)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed))

    def next(self):
        """One 63-bit seed drawn from the stream, for a batch sharded
        over a mesh (``parallel.shard_generator``); the JAX package
        splits its key here."""
        return int(torch.randint(0, 2 ** 63 - 1, (1,),
                                 generator=self.generator,
                                 device=self.generator.device))


def get_rng_states(size=None, seed=1, device=None):
    """API-compatible RNG construction; ``size`` is ignored."""
    return RNGStream(seed, device)


def create_cuda_context(device=None):
    """A context object whose ``pop()`` does nothing, kept so that
    drivers written for the reference run unchanged: PyTorch owns the
    card's context."""
    class _Context(object):
        def pop(self):
            pass
    return _Context()


class GPUGeometry(object):
    """Packed device geometry (reference: chroma/gpu/geometry.py)."""

    def __init__(self, geometry, device=None, wavelengths=None, times=None):
        self.device = _device(device)
        self.geometry = geometry
        self.geom = pack_geometry(geometry, self.device,
                                  wavelengths=wavelengths, times=times)
        self.det = None
        self.solid_id_map = self.geom.solid_id_map

    def tables_on(self, device):
        """(geom, det) on ``device``: the tables themselves on their own
        device; elsewhere a copy of every tensor, made once a device and
        kept on this object (packing again would cost the host minutes
        on a large detector)."""
        device = torch.device(device)
        if device == self.geom.mbvh_rows.device:
            return self.geom, self.det
        copies = self.__dict__.setdefault('_copies', {})
        src, geom, det = copies.get(device, (None, None, None))
        if src is not self.geom:        # first use, or recoloured since
            geom = self.geom.to(device)
            det = None if self.det is None else self.det.to(device)
            copies[device] = (self.geom, geom, det)
        return geom, det

    def device_usage_str(self):
        total = sum(v.numel() * v.element_size()
                    for v in vars(self.geom).values()
                    if isinstance(v, torch.Tensor))
        return 'geometry tables: %.1f MB' % (total / 1e6)

    def print_device_usage(self):
        print(self.device_usage_str())

    def color_solids(self, solid_hit, colors):
        """Recolor all triangles of hit solids (reference:
        chroma/gpu/geometry.py color_solids).  ``colors`` are uint32
        per solid; the table holds their bits as int32."""
        dev = self.geom.colors.device
        solid_hit = torch.from_numpy(
            np.ascontiguousarray(solid_hit, dtype=bool)).to(dev)
        colors = torch.from_numpy(np.ascontiguousarray(
            colors, dtype=np.uint32).view(np.int32)).to(dev)
        tri_solid = self.geom.solid_id_map.long()
        self.geom = dataclasses.replace(self.geom, colors=torch.where(
            solid_hit[tri_solid], colors[tri_solid], self.geom.colors))


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
                  use_weights=False, scatter_first=0, track=False,
                  driver='fused', width=None, service_every=None,
                  od_slots=1, mesh=None, ondeck=True, prune='on',
                  service_frac=None, drain_shrink=fused_ops.DRAIN_SHRINK,
                  chains=fused_ops.DEFAULT_CHAINS, collect_stats=False,
                  sort_every=0):
        """Propagate every photon to termination or ``max_steps``
        (reference gpu/photon.py:192), drawing from the generator of
        ``rng_states``.  ``use_weights`` and ``scatter_first`` are
        ``ops/propagate.physics_update``'s.

        ``driver='fused'`` (the default, as in the JAX package) runs the
        lane-pool driver ops/fused.propagate_fused with ``width``,
        ``service_every``, ``od_slots``, ``ondeck``, ``prune``,
        ``service_frac``, ``drain_shrink``, ``chains`` and
        ``collect_stats`` (its docstring has their meaning) and keeps
        its int32[4] stats [service passes, photon-steps,
        lane-iterations, active lane-iterations] in ``last_stats``.
        ``driver='steps'`` runs the step loop ops/photon.propagate, with
        the batch in Morton order before every ``sort_every``-th step
        when that is > 0; ``driver='compacting'`` the round loop
        ops/photon.propagate_compacting.  Both keep their step count in
        ``last_steps`` and give the photons back in upload order.

        ``track=True`` ignores ``driver``: one ``propagate_step`` over
        the whole batch per host step, and returns (step_photon_ids,
        step_photons), a snapshot after every step with step 0 the
        photons as uploaded.  Each step draws one (n, NDRAWS) block in
        which a photon reads the row of its ``index``, as the step loop
        does, so from one generator seed the last snapshot equals
        ``driver='steps'`` bit for bit.

        ``mesh`` (``parallel.make_photon_mesh``) of more than one device,
        without ``track``: the batch is padded to a multiple of the mesh,
        sharded over it with one seed from ``rng_states.next()``
        (``parallel.propagate_sharded``), put back in upload order and
        cut to its length; ``last_stats`` is the shards' stats summed.
        The step loop has no sharded form (``driver='steps'`` raises).
        """
        geom = gpu_geometry.geom
        fused_kw = dict(
            width=width, od_slots=od_slots, ondeck=ondeck, prune=prune,
            service_every=service_every or fused_ops.SERVICE_EVERY,
            service_frac=service_frac, drain_shrink=drain_shrink,
            chains=chains, collect_stats=collect_stats)
        if mesh is not None and mesh.size > 1 and not track:
            if driver != 'fused':
                raise ValueError("a mesh of %d devices propagates with "
                                 "driver='fused' only, got %r"
                                 % (mesh.size, driver))
            n = len(self)
            state, _ = parallel.pad_to_multiple(self.state, mesh.size)
            state, stats = parallel.propagate_sharded(
                state, gpu_geometry, rng_states.next(), mesh,
                max_steps=max_steps, use_weights=use_weights,
                scatter_first=scatter_first, **fused_kw)
            state = photon_ops.unsort_photons(state)
            self.state = {k: v[:n] for k, v in state.items()}
            self.last_stats = stats.cpu().numpy()
            self.last_steps = None
            return None
        if track:
            return self._propagate_tracking(geom, rng_states, max_steps,
                                            scatter_first, use_weights)
        if driver == 'fused':
            self.state, stats = fused_ops.propagate_fused(
                self.state, geom, fused_ops.uniform_draws(
                    rng_states.generator),
                max_steps=max_steps, scatter_first=scatter_first,
                use_weights=use_weights, **fused_kw)
            self.last_stats = stats.cpu().numpy()
            self.last_steps = None
        elif driver in ('steps', 'compacting'):
            # a photon reads the draw row of its index: 0..n-1 here, the
            # caller's index put back after
            caller_index = self.state['index']
            state = dict(self.state, index=torch.arange(
                len(self), device=caller_index.device))
            draws = photon_ops.uniform_draws(rng_states.generator,
                                             len(self))
            kw = dict(max_steps=max_steps, scatter_first=scatter_first,
                      use_weights=use_weights)
            if driver == 'steps':
                state, steps = photon_ops.propagate(
                    state, geom, draws, sort_every=sort_every, **kw)
                if sort_every:
                    state = photon_ops.unsort_photons(state)
            else:
                state, steps = photon_ops.propagate_compacting(
                    state, geom, draws, **kw)
            self.state = dict(state, index=caller_index)
            self.last_steps, self.last_stats = steps, None
        else:
            raise ValueError("driver must be 'fused', 'steps' or "
                             "'compacting', got %r" % (driver,))

    def _propagate_tracking(self, geom, rng_states, max_steps,
                            scatter_first, use_weights):
        draws = photon_ops.uniform_draws(rng_states.generator, len(self))
        ids = np.arange(len(self))
        step_ids = [ids.copy()]
        step_photons = [photon_ops.download_photons(self.state)]
        steps = 0
        while steps < max_steps and bool(
                alive_mask(self.state['flags']).any()):
            u = draws()[self.state['index']]
            self.state = propagate_step(
                self.state, geom, u, scatter_first if steps == 0 else 0,
                use_weights=use_weights)
            steps += 1
            step_ids.append(ids.copy())
            step_photons.append(photon_ops.download_photons(self.state))
        self.last_steps, self.last_stats = steps, None
        return step_ids, step_photons

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

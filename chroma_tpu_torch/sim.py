"""Simulation: batch photon bundles, propagate them, digitize the hits.

Counterpart of chroma_tpu/sim.py for photon input (``geant4_processes=0``)
on one device.  The event batching and de-batching is the JAX package's;
photon generation from particle vertices, photon tracking, multi-device
meshes and the PDF / likelihood methods are not ported yet.
"""
import os
import time

import numpy as np
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch import itertoolset
from chroma_tpu_torch import gpu
from chroma_tpu_torch.ops import daq as daq_ops


def pick_seed():
    """Seed from time + PID (reference: chroma/sim.py:16)."""
    return int(time.time()) ^ (os.getpid() << 16) & (2 ** 32 - 1)


class Simulation(object):
    def __init__(self, detector, seed=None, geant4_processes=0,
                 device=None, driver='fused'):
        """``detector``: a Geometry/Detector (flattened here if needed)
        or a geometry string for chroma_tpu_torch.loader.  Photon generation
        from vertices (``geant4_processes`` > 0) is not ported.
        ``driver`` is ``GPUPhotons.propagate``'s: 'fused' (the on-deck
        lane-pool driver) or 'steps' (the step loop)."""
        if geant4_processes:
            raise NotImplementedError(
                'photon generation from vertices (geant4_processes > 0) is '
                'not ported to chroma_tpu_torch; pass Photons or Events '
                'with photons_beg')
        if isinstance(detector, str):
            from chroma_tpu_torch.loader import load_geometry_from_string
            detector = load_geometry_from_string(detector)
        detector.flatten()
        self.detector = detector
        self.driver = driver
        self.device = torch.device(device) if device is not None \
            else gpu.default_device()
        self.seed = pick_seed() if seed is None else seed
        np.random.seed(self.seed)
        if hasattr(detector, 'num_channels'):
            self.gpu_geometry = gpu.GPUDetector(detector, self.device)
        else:
            self.gpu_geometry = gpu.GPUGeometry(detector, self.device)
        self.rng_states = gpu.get_rng_states(seed=self.seed,
                                             device=self.device)

    def _simulate_batch(self, batch_events, keep_photons_beg=False,
                        keep_photons_end=False, keep_hits=True,
                        keep_flat_hits=True, run_daq=False, max_steps=100):
        batch_photons = event.Photons.join(
            [ev.photons_beg for ev in batch_events])
        batch_bounds = np.cumsum(np.concatenate(
            [[0], [len(ev.photons_beg) for ev in batch_events]]))

        gpu_photons = gpu.GPUPhotons(batch_photons, self.device,
                                     copy_triangles=False,
                                     copy_weights=False)
        gpu_photons.propagate(self.gpu_geometry, self.rng_states,
                              max_steps=max_steps, driver=self.driver)
        is_detector = hasattr(self.detector, 'num_channels')

        if keep_photons_end:
            batch_photons_end = gpu_photons.get()
        if is_detector and (keep_hits or keep_flat_hits):
            batch_hits = gpu_photons.get_flat_hits(self.gpu_geometry)
        if is_detector and run_daq:
            # one DAQ over the whole batch, into per-event channel blocks
            # keyed by evidx
            nch = self.gpu_geometry.nchannels
            u = daq_ops.daq_draws(self.rng_states.generator, 1,
                                  len(gpu_photons))
            channels = daq_ops.run_daq(
                gpu_photons.state, self.gpu_geometry.geom,
                self.gpu_geometry.det, u, nch, nevents=len(batch_events))

        for i, (batch_ev, (start, end)) in enumerate(zip(
                batch_events, zip(batch_bounds[:-1], batch_bounds[1:]))):
            if not keep_photons_beg:
                batch_ev.photons_beg = None
            if keep_photons_end:
                batch_ev.photons_end = batch_photons_end[start:end]
            if is_detector and (keep_hits or keep_flat_hits):
                ev_hits = batch_hits[batch_hits.evidx == i]
                if keep_hits:
                    batch_ev.hits = {
                        int(c): ev_hits[ev_hits.channel == c]
                        for c in np.unique(ev_hits.channel)}
                if keep_flat_hits:
                    batch_ev.flat_hits = ev_hits
            if is_detector and run_daq:
                sl = slice(i * nch, (i + 1) * nch)
                batch_ev.channels = gpu.GPUChannels(
                    channels['t'][sl], channels['q'][sl],
                    channels['flags'][sl]).get()
            yield batch_ev

    def simulate(self, iterable, keep_photons_beg=False,
                 keep_photons_end=False, keep_hits=True,
                 keep_flat_hits=True, run_daq=False, max_steps=100,
                 photons_per_batch=1000000, evid_start=0):
        """Yield simulated Events for an iterable of Photons or of Events
        that carry ``photons_beg`` (reference: chroma/sim.py:141)."""
        if isinstance(iterable, event.Photons):
            first_element, iterable = iterable, [iterable]
        else:
            first_element, iterable = itertoolset.peek(iterable)

        if isinstance(first_element, event.Photons):
            iterable = (event.Event(photons_beg=x) for x in iterable)
        elif not isinstance(first_element, event.Event) \
                or first_element.photons_beg is None:
            raise NotImplementedError(
                'chroma_tpu_torch simulates Photons or Events that carry '
                'photons_beg; photon generation is not ported')

        nphotons = 0
        batch_events = []
        evid = evid_start
        kw = dict(keep_photons_beg=keep_photons_beg,
                  keep_photons_end=keep_photons_end, keep_hits=keep_hits,
                  keep_flat_hits=keep_flat_hits, run_daq=run_daq,
                  max_steps=max_steps)
        for ev in iterable:
            ev.id = evid
            evid += 1
            ev.nphotons = len(ev.photons_beg)
            ev.photons_beg.evidx[:] = len(batch_events)
            nphotons += ev.nphotons
            batch_events.append(ev)
            if nphotons >= photons_per_batch:
                yield from self._simulate_batch(batch_events, **kw)
                nphotons = 0
                batch_events = []
        if batch_events:
            yield from self._simulate_batch(batch_events, **kw)

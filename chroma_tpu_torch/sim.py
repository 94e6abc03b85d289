"""Simulation: batch photon bundles, propagate them, digitize the hits,
and fill or evaluate the PDFs a likelihood fit reads.

Counterpart of chroma_tpu/sim.py.  The event batching and de-batching
is the JAX package's.  Photon generation from particle vertices runs in
a pool of worker processes (ZMQ), as there; set ``geant4_processes=0``
(the default here) to feed Photons directly.  ``devices`` or ``mesh``
shard every propagation over several devices (chroma_tpu_torch.parallel).
"""
import os
import time

import numpy as np
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch import generator
from chroma_tpu_torch import itertoolset
from chroma_tpu_torch import gpu
from chroma_tpu_torch import parallel
from chroma_tpu_torch import tracing
from chroma_tpu_torch.device import resolve
from chroma_tpu_torch.ops import daq as daq_ops
from chroma_tpu_torch.ops import photon as photon_ops


def pick_seed():
    """Seed from time + PID (reference: chroma/sim.py:16)."""
    return int(time.time()) ^ (os.getpid() << 16) & (2 ** 32 - 1)


def _photon_tracks(tracking, start, end):
    """One Photons polyline per photon of [start, end) from the
    (step_photon_ids, step_photons) snapshots of tracking mode."""
    step_ids, step_photons = tracking
    tracks = [[] for _ in range(end - start)]
    for ids, photons in zip(step_ids, step_photons):
        mask = (ids >= start) & (ids < end)
        sub = photons[mask]
        for j, pid in enumerate(ids[mask] - start):
            tracks[pid].append(sub[j:j + 1])
    return [event.Photons.join(t) if t else event.Photons() for t in tracks]


def _split_by(keys, n):
    """Split rows by an integer key in [0, n) in one pass: ``(order,
    bounds)``, where the rows of key k are ``order[bounds[k]:bounds[k +
    1]]``, or ``bounds[k]:bounds[k + 1]`` when ``order`` is None, as it
    is for non-decreasing ``keys``; otherwise ``order`` is one stable
    argsort, so each key's rows keep the order a mask would give them.
    Rows of a key outside [0, n) fall in no key's range."""
    order = None
    if len(keys) > 1 and (keys[1:] < keys[:-1]).any():
        order = np.argsort(keys, kind='stable')
        keys = keys[order]
    return order, np.searchsorted(keys, np.arange(n + 1, dtype=keys.dtype))


def _copy(photons):
    """A Photons that owns copies of ``photons``' arrays."""
    return event.Photons(**{f: getattr(photons, f).copy()
                            for f in event._FIELDS})


def _split_hits(hits, nevents):
    """Each event's rows of the batch's flat ``hits``, by ``evidx``, as
    Photons that own their arrays: an event kept alone does not pin the
    batch.  Counts ``simulate.debatch_resorted`` when the rows came out
    of event order and had to be sorted."""
    order, bounds = _split_by(hits.evidx, nevents)
    if order is not None:
        tracing.count('simulate.debatch_resorted', 1)
        hits = hits[order]
    return [_copy(hits[lo:hi]) for lo, hi in zip(bounds[:-1], bounds[1:])]


def _by_channel(hits):
    """``{channel: its hits}``, channels ascending and each channel's
    rows in their order in ``hits``, as a mask a channel gives them; the
    values are slices of one gathered copy."""
    n = int(hits.channel.max()) + 1 if len(hits) else 0
    order, bounds = _split_by(hits.channel, n)
    hits = _copy(hits) if order is None else hits[order]
    return {int(c): hits[bounds[c]:bounds[c + 1]]
            for c in np.flatnonzero(np.diff(bounds))}


class Simulation(object):
    def __init__(self, detector, seed=None, geant4_processes=0,
                 device=None, driver='fused', photon_tracking=False,
                 particle_tracking=False, devices=None, mesh=None,
                 driver_options=None):
        """``detector``: a Geometry/Detector (flattened here if needed),
        a geometry string for chroma_tpu_torch.loader, or packed tables
        already on a device (a ``gpu.GPUDetector`` or ``gpu.GPUGeometry``,
        for example from ``GPUDetector.from_table_cache``: nothing is
        packed again and ``device`` is theirs; they must hold their host
        ``geometry`` when ``geant4_processes`` > 0, for its
        ``detector_material``).  ``geant4_processes`` > 0 starts that
        many photon-generator workers (``generator.G4ParallelGenerator``)
        for Vertex input and photon-less Events; ``close()`` ends them.
        The JAX package defaults to 4; the port defaults to 0, because
        its workers are spawned (a fork is unsafe once CUDA is up), which
        costs seconds, and callers that feed Photons should not pay for
        a pool they never use.  ``particle_tracking`` keeps the
        generator's particle steps on the vertices.  ``driver`` is
        ``GPUPhotons.propagate``'s: 'fused' (the on-deck lane-pool
        driver), 'steps' (the step loop) or 'compacting' (the round loop);
        ``driver_options`` (a dict) are its other keywords, passed to
        every propagation: ``width``, ``service_every``, ``od_slots``,
        ``ondeck``, ``prune``, ``service_frac``, ``drain_shrink``,
        ``chains``, ``collect_stats`` for 'fused', ``sort_every`` for
        'steps'.  ``photon_tracking`` runs the tracking mode instead and
        fills each event's ``photon_tracks``.

        ``devices`` (a device list, repeats allowed) or ``mesh`` (a
        ``parallel.PhotonMesh``) shard every propagation over those
        devices; ``device`` then defaults to the mesh's first.  With
        neither, tables on a card and more than one card in the
        process, the mesh is every card.  A mesh of one device runs
        unsharded.  Sharding needs ``driver='fused'``: the step loop
        raises ``ValueError`` when it propagates on a larger mesh."""
        if mesh is None and devices is not None:
            mesh = parallel.make_photon_mesh(devices)
        if device is None and mesh is not None:
            device = mesh.devices[0]
        self.driver = driver
        self.driver_options = dict(driver_options or {})
        self.photon_tracking = photon_tracking
        self.seed = pick_seed() if seed is None else seed
        np.random.seed(self.seed)
        if isinstance(detector, gpu.GPUGeometry):
            self.gpu_geometry = detector
            self.detector = detector.geometry
            self.device = detector.device
        else:
            if isinstance(detector, str):
                from chroma_tpu_torch.loader import load_geometry_from_string
                detector = load_geometry_from_string(detector)
            detector.flatten()
            self.detector = detector
            self.device = resolve(device)
            if hasattr(detector, 'num_channels'):
                self.gpu_geometry = gpu.GPUDetector(detector, self.device)
            else:
                self.gpu_geometry = gpu.GPUGeometry(detector, self.device)
        self.photon_generator = None
        if geant4_processes > 0:
            if self.detector is None:
                raise ValueError(
                    'geant4_processes > 0 needs the host detector for its '
                    'detector_material; these packed tables carry none')
            self.photon_generator = generator.G4ParallelGenerator(
                geant4_processes, self.detector.detector_material,
                base_seed=self.seed, tracking=particle_tracking)
        self.is_detector = self.gpu_geometry.det is not None
        if self.is_detector:
            self.gpu_daq = gpu.GPUDaq(self.gpu_geometry)
            self.gpu_pdf = gpu.GPUPDF()
            self.gpu_pdf_kernel = gpu.GPUKernelPDF()
        if mesh is None and self.device.type == 'cuda' \
                and torch.cuda.device_count() > 1:
            mesh = parallel.make_photon_mesh()
        self.mesh = mesh
        self.rng_states = gpu.get_rng_states(seed=self.seed,
                                             device=self.device)
        self.pdf_config = None

    def _propagate(self, gpu_photons, **kw):
        """``gpu_photons.propagate`` with this simulation's geometry,
        generator, driver, its options and mesh."""
        return gpu_photons.propagate(
            self.gpu_geometry, self.rng_states, driver=self.driver,
            mesh=self.mesh, **self.driver_options, **kw)

    def close(self):
        """End the photon-generator workers, if any."""
        if self.photon_generator is not None:
            self.photon_generator.close()
            self.photon_generator = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _simulate_batch(self, batch_events, keep_photons_beg=False,
                        keep_photons_end=False, keep_hits=True,
                        keep_flat_hits=True, run_daq=False, max_steps=100):
        with tracing.span('simulate.join'):
            batch_photons = event.Photons.join(
                [ev.photons_beg for ev in batch_events])
            batch_bounds = np.cumsum(np.concatenate(
                [[0], [len(ev.photons_beg) for ev in batch_events]]))

        with tracing.span('simulate.upload'):
            gpu_photons = gpu.GPUPhotons(batch_photons, self.device,
                                         copy_triangles=False,
                                         copy_weights=False)
        is_detector = self.is_detector
        nch = self.gpu_geometry.nchannels if is_detector else 0
        channels = None
        if run_daq and is_detector and self.mesh is not None \
                and self.mesh.size > 1 and not self.photon_tracking:
            # propagation and DAQ in each shard, the channels combined
            # across shards (min, sum, OR) instead of one DAQ over the
            # gathered batch
            if self.driver != 'fused':
                raise ValueError("a mesh of %d devices propagates with "
                                 "driver='fused' only, got %r"
                                 % (self.mesh.size, self.driver))
            n = len(gpu_photons)
            with tracing.span('simulate.propagate'):
                state, _ = parallel.pad_to_multiple(gpu_photons.state,
                                                    self.mesh.size)
                state, channels = parallel.propagate_and_daq_sharded(
                    state, self.gpu_geometry, self.rng_states.next(),
                    self.mesh, nch, max_steps=max_steps,
                    nevents=len(batch_events), **self.driver_options)
                state = photon_ops.unsort_photons(state)
                gpu_photons.state = {k: v[:n] for k, v in state.items()}
            tracking = None
        else:
            with tracing.span('simulate.propagate'):
                tracking = self._propagate(gpu_photons, max_steps=max_steps,
                                           track=self.photon_tracking)

        if keep_photons_end:
            batch_photons_end = gpu_photons.get()
        if is_detector and (keep_hits or keep_flat_hits):
            with tracing.span('simulate.hits'):
                batch_hits = gpu_photons.get_flat_hits(self.gpu_geometry)
                if tracing.recorder is not None \
                        and self.gpu_geometry.geom.has_reemission:
                    flags = gpu_photons.state['flags']
                    tracing.count('simulate.reemitted', int(
                        ((flags & event.BULK_REEMIT) != 0).sum()))
        if is_detector and run_daq and channels is None:
            # one DAQ over the whole batch, into per-event channel blocks
            # keyed by evidx
            with tracing.span('simulate.daq'):
                u = daq_ops.daq_draws(self.rng_states.generator, 1,
                                      len(gpu_photons))
                channels = daq_ops.run_daq(
                    gpu_photons.state, self.gpu_geometry.geom,
                    self.gpu_geometry.det, u, nch,
                    nevents=len(batch_events))

        keep_any_hits = is_detector and (keep_hits or keep_flat_hits)
        for i, (batch_ev, (start, end)) in enumerate(zip(
                batch_events, zip(batch_bounds[:-1], batch_bounds[1:]))):
            # closed before the yield: a consumer's time is not the split's
            with tracing.span('simulate.debatch'):
                if i == 0:
                    # the batch's split, once, in its first event's span:
                    # every event's hits (the drivers hand the photons
                    # back in upload order, so in evidx order), split on
                    # the host while the device runs the DAQ, then one
                    # download of every event's channels
                    if keep_any_hits:
                        ev_hits = _split_hits(batch_hits, len(batch_events))
                        del batch_hits
                    if is_detector and run_daq:
                        batch_channels = gpu.GPUChannels(
                            channels['t'], channels['q'],
                            channels['flags']).get()
                if not keep_photons_beg:
                    batch_ev.photons_beg = None
                if tracking is not None:
                    batch_ev.photon_tracks = _photon_tracks(tracking, start,
                                                            end)
                if keep_photons_end:
                    batch_ev.photons_end = batch_photons_end[start:end]
                if keep_any_hits:
                    # handed over: the generator keeps no event's hits
                    hits, ev_hits[i] = ev_hits[i], None
                    if keep_hits:
                        batch_ev.hits = _by_channel(hits)
                    if keep_flat_hits:
                        batch_ev.flat_hits = hits
                if is_detector and run_daq:
                    sl = slice(i * nch, (i + 1) * nch)
                    c = batch_channels
                    batch_ev.channels = event.Channels(
                        c.hit[sl].copy(), c.t[sl].copy(), c.q[sl].copy(),
                        c.flags[sl].copy())
            yield batch_ev

    def simulate(self, iterable, keep_photons_beg=False,
                 keep_photons_end=False, keep_hits=True,
                 keep_flat_hits=True, run_daq=False, max_steps=100,
                 photons_per_batch=1000000, evid_start=0):
        """Yield simulated Events for an iterable of Photons / Vertex /
        Event objects (reference: chroma/sim.py:141)."""
        iterable = self._photon_events(iterable, regenerate=True)
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

    # ------------------------------------------------------------------

    def _photon_events(self, iterable, regenerate=False):
        """An iterable of Events with ``photons_beg`` filled, from a bare
        Photons bundle (ONE event, as in ``simulate``) or an iterable of
        Photons, Vertex or Event objects.  Events that already carry
        photons (a ``Photons`` in ``photons_beg``: the particle guns park
        their vertex list there) pass as they are, unless ``regenerate``
        and there is a generator pool (``simulate`` then makes their
        photons anew from their vertices, as the JAX package's does)."""
        if isinstance(iterable, event.Photons):
            first_element, iterable = iterable, [iterable]
        else:
            first_element, iterable = itertoolset.peek(iterable)
        if isinstance(first_element, event.Photons):
            return (event.Event(photons_beg=x) for x in iterable)
        if isinstance(first_element, event.Vertex):
            iterable = (event.Event(vertices=[v]) for v in iterable)
        elif not isinstance(first_element, event.Event):
            raise TypeError('cannot simulate %r' % type(first_element))
        elif isinstance(first_element.photons_beg, event.Photons) and not (
                regenerate and self.photon_generator is not None):
            return iterable
        if self.photon_generator is None:
            raise RuntimeError('events carry no photons and the '
                               'simulation was created with '
                               'geant4_processes=0')
        return self.photon_generator.generate_events(iterable)

    def _acquire(self, gpu_daq, *photon_sets):
        """One readout of ``gpu_daq`` over (photons, weight) pairs."""
        gpu_daq.begin_acquire()
        for photons, weight in photon_sets:
            gpu_daq.acquire(photons, self.rng_states, weight=weight)
        return gpu_daq.end_acquire()

    def create_pdf(self, iterable, tbins, trange, qbins, qrange, nreps=1):
        """(hitcounts, 3D (channel, t, q) pdf histogram) from simulating
        the given events (reference: chroma/sim.py:188)."""
        iterable = self._photon_events(iterable)
        pdf_config = (tbins, trange, qbins, qrange)
        if pdf_config != self.pdf_config:
            self.pdf_config = pdf_config
            self.gpu_pdf.setup_pdf(self.gpu_geometry.nchannels, tbins,
                                   trange, qbins, qrange)
        else:
            self.gpu_pdf.clear_pdf()
        if nreps > 1:
            iterable = itertoolset.repeating_iterator(iterable, nreps)
        for ev in iterable:
            gpu_photons = gpu.GPUPhotons(ev.photons_beg, self.device)
            self._propagate(gpu_photons)
            self.gpu_pdf.add_hits_to_pdf(
                self._acquire(self.gpu_daq, (gpu_photons, 1.0)))
        return self.gpu_pdf.get_pdfs()

    def eval_pdf(self, event_channels, iterable, min_twidth, trange,
                 min_qwidth, qrange, min_bin_content=100, nreps=1, ndaq=1,
                 nscatter=1, time_only=True):
        """Variable-bin PDF evaluation with importance-weighted
        scatter / no-scatter splits (reference: chroma/sim.py:219).
        Returns (hitcount, pdf value, pdf uncertainty) per channel."""
        ndaq_per_rep = min(64, ndaq)
        ndaq_reps = max(ndaq // ndaq_per_rep, 1)
        gpu_daq = gpu.GPUDaq(self.gpu_geometry, ndaq=ndaq_per_rep)

        self.gpu_pdf.setup_pdf_eval(event_channels.hit, event_channels.t,
                                    event_channels.q, min_twidth, trange,
                                    min_qwidth, qrange,
                                    min_bin_content=min_bin_content,
                                    time_only=time_only)

        for ev in self._photon_events(iterable):
            no_scatter = gpu.GPUPhotons(ev.photons_beg, self.device,
                                        ncopies=nreps)
            scatter = gpu.GPUPhotons(ev.photons_beg, self.device,
                                     ncopies=nreps * nscatter)
            self._propagate(no_scatter, use_weights=True, scatter_first=-1,
                            max_steps=10)
            self._propagate(scatter, use_weights=True, scatter_first=1,
                            max_steps=5)
            stride = no_scatter.stride
            for i in range(no_scatter.ncopies):
                ns_slice = no_scatter.select(event.SURFACE_DETECT,
                                             start_photon=i * stride,
                                             nphotons=stride)
                if ns_slice.true_nphotons == 0:
                    continue
                sets = [(ns_slice, 1.0)]
                for j in range(nscatter):
                    sc = scatter.select(
                        event.SURFACE_DETECT,
                        start_photon=(nscatter * i + j) * scatter.stride,
                        nphotons=scatter.stride)
                    if sc.true_nphotons:
                        sets.append((sc, 1.0 / nscatter))
                for _ in range(ndaq_reps):
                    self.gpu_pdf.accumulate_pdf_eval(
                        self._acquire(gpu_daq, *sets))
        return self.gpu_pdf.get_pdf_eval()

    def _each_readout(self, iterable, nreps, ndaq):
        """Single-DAQ channel readouts: every event of ``iterable``
        propagated in ``nreps`` copies, each copy digitized ``ndaq``
        times."""
        for ev in self._photon_events(iterable):
            gpu_photons = gpu.GPUPhotons(ev.photons_beg, self.device,
                                         ncopies=nreps)
            self._propagate(gpu_photons)
            for ph_slice in gpu_photons.iterate_copies():
                for _ in range(ndaq):
                    yield self._acquire(self.gpu_daq, (ph_slice, 1.0))

    def setup_kernel(self, event_channels, bandwidth_iterable, trange,
                     qrange, nreps=1, ndaq=1, time_only=True,
                     scale_factor=1.0):
        """Accumulate moments and compute the KDE bandwidths
        (reference: chroma/sim.py:285)."""
        self.gpu_pdf_kernel.setup_moments(len(event_channels.hit), trange,
                                          qrange, time_only=time_only)
        for channels in self._each_readout(bandwidth_iterable, nreps, ndaq):
            self.gpu_pdf_kernel.accumulate_moments(channels)
        self.gpu_pdf_kernel.compute_bandwidth(event_channels.hit,
                                              event_channels.t,
                                              event_channels.q,
                                              scale_factor=scale_factor)

    def eval_kernel(self, event_channels, kernel_iterable, trange, qrange,
                    nreps=1, ndaq=1, naverage=1, time_only=True):
        """(hitcount, KDE pdf values, zeros) (reference:
        chroma/sim.py:315)."""
        self.gpu_pdf_kernel.setup_kernel(event_channels.hit,
                                         event_channels.t,
                                         event_channels.q)
        for channels in self._each_readout(kernel_iterable, nreps, ndaq):
            self.gpu_pdf_kernel.accumulate_kernel(channels)
        return self.gpu_pdf_kernel.get_kernel_eval()

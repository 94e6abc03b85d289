"""Photon-axis data parallelism over a list of devices.

Counterpart of chroma_tpu/parallel/__init__.py, with its names.  A photon
batch is cut into ``mesh.size`` contiguous shards; each shard runs the
on-deck driver (ops/fused.propagate_fused) on its own device, against a
copy of the packed tables on that device (``GPUGeometry.tables_on``)
and with its own generator (``shard_generator``), and no shard waits
for another while it propagates.  The DAQ's channel arrays are then
combined on the mesh's first device: the earliest time by a min, the
charge by a float sum in shard order and the history word by a bitwise
OR (the JAX package's pmin, psum and OR-fold; the reference's
atomicMin, atomicAdd and atomicOr, chroma/cuda/daq.cu:73-75).

One host thread a distinct device runs that device's shards in shard
order under ``torch.cuda.device``.  A device may appear in the mesh
more than once: on one card the shards run one after another (the same
results on every run, and no gain); on N cards N shards run at once.  A
mesh of CPU devices runs in the caller's thread.  A shard's exception
is raised to the caller; nothing is run again unsharded.
"""
import concurrent.futures
import contextlib
import dataclasses

import numpy as np
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.device import default_device
from chroma_tpu_torch.ops import daq as daq_ops
from chroma_tpu_torch.ops import fused
from chroma_tpu_torch.ops.propagate import i32

# the words of a padding photon that are not 0: terminal (NO_HIT), no
# last hit, and evidx -1 (the JAX package's 0xFFFFFFFF), which run_daq's
# evidx >= 0 test drops
_PAD_FILL = dict(flags=i32(event.NO_HIT), last_hit_triangle=-1, evidx=-1)


@dataclasses.dataclass(frozen=True)
class PhotonMesh:
    """A 1D device mesh: ``devices`` in shard order, repeats allowed."""
    devices: tuple
    axis_names: tuple = ('photons',)

    @property
    def size(self):
        return len(self.devices)


def _canonical(device):
    """``device`` with its index: 'cuda' is the current card."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def make_photon_mesh(devices=None, axis_name='photons'):
    """A PhotonMesh over ``devices``; ``None`` is every CUDA card, and
    raises where there is none (a mesh of CPU devices is made only when
    the caller names them, as in ``['cpu', 'cpu']``)."""
    if devices is None:
        default_device()
        devices = ['cuda:%d' % i for i in range(torch.cuda.device_count())]
    devices = tuple(_canonical(d) for d in devices)
    if not devices:
        raise ValueError('a photon mesh needs at least one device')
    return PhotonMesh(devices, (axis_name,))


def pad_to_multiple(state, multiple):
    """Pad a photon state dict so that ``multiple`` divides the batch.
    Padding photons are terminal with weight 0 (``_PAD_FILL``), and
    ``index`` becomes arange over the padded batch.  Returns
    ``(state, n)`` with ``n`` the batch before padding."""
    n = state['pos'].shape[0]
    pad = -n % multiple
    if pad == 0:
        return state, n
    out = {k: torch.cat([v, torch.full((pad,) + tuple(v.shape[1:]),
                                       _PAD_FILL.get(k, 0), dtype=v.dtype,
                                       device=v.device)])
           for k, v in state.items()}
    if 'index' in out:
        out['index'] = torch.arange(n + pad, device=out['index'].device)
    return out, n


def shard_generator(seed, d, device):
    """Shard ``d``'s generator on ``device``, seeded with the 64-bit
    word of ``np.random.SeedSequence([seed, d])``: the counterpart of
    ``jax.random.fold_in(key, d)``.  ``seed`` is the batch's seed
    (``gpu.RNGStream.next()``).  The shard draws its propagation blocks
    from it and then, where there is a DAQ, its DAQ block: the port's
    form of the JAX package's ``k_prop, k_daq = split(local_key)``."""
    word = np.random.SeedSequence([int(seed), int(d)]).generate_state(
        1, np.uint64)[0]
    generator = torch.Generator(device=device)
    generator.manual_seed(int(word))
    return generator


def _shards(state, mesh):
    """The contiguous shards of ``state``, each moved to its device."""
    n = state['pos'].shape[0]
    if n % mesh.size:
        raise ValueError('a batch of %d photons does not divide into %d '
                         'shards; pad it first (pad_to_multiple)'
                         % (n, mesh.size))
    m = n // mesh.size
    return [{k: v[d * m:(d + 1) * m].to(dev) for k, v in state.items()}
            for d, dev in enumerate(mesh.devices)]


def _map_shards(mesh, fn):
    """``[fn(d) for d in range(mesh.size)]``, one host thread a distinct
    device running that device's shards in order (the caller's thread
    where there is one device); a shard's exception is raised here."""
    groups = {}
    for d, dev in enumerate(mesh.devices):
        groups.setdefault(dev, []).append(d)
    out = [None] * mesh.size

    def run(dev, shards):
        with (torch.cuda.device(dev) if dev.type == 'cuda'
              else contextlib.nullcontext()):
            for d in shards:
                out[d] = fn(d)

    if len(groups) == 1:
        run(*next(iter(groups.items())))
    else:
        with concurrent.futures.ThreadPoolExecutor(len(groups)) as pool:
            futures = [pool.submit(run, dev, shards)
                       for dev, shards in groups.items()]
        for f in futures:
            f.result()
    return out


def propagate_sharded(state, gpu_geometry, seed, mesh, max_steps=100,
                      use_weights=False, scatter_first=0, **fused_kw):
    """Propagate a photon batch sharded over ``mesh``: shard ``d``
    runs ``propagate_fused`` on ``mesh.devices[d]`` with the generator
    ``shard_generator(seed, d, device)``; the other arguments
    (``fused_kw`` too: width, service_every, od_slots and the driver's
    other options) are ``propagate_fused``'s.  The batch must divide
    into the shards (``pad_to_multiple``).

    Returns ``(state, stats)`` on the state's own device: the shards in
    order, each with the caller's ``index``, and the shards' int32[4]
    stats summed."""
    home = state['pos'].device
    shards = _shards(state, mesh)

    def run(d):
        dev = mesh.devices[d]
        geom, _ = gpu_geometry.tables_on(dev)
        return fused.propagate_fused(
            shards[d], geom, fused.uniform_draws(
                shard_generator(seed, d, dev)),
            max_steps=max_steps, scatter_first=scatter_first,
            use_weights=use_weights, **fused_kw)

    outs = _map_shards(mesh, run)
    out = {k: torch.cat([o[k].to(home) for o, _ in outs]) for k in state}
    stats = torch.stack([s.to(home) for _, s in outs]).sum(dim=0)
    return out, stats.to(torch.int32)


def reduce_channels(channels, device):
    """Per-shard DAQ channel dicts combined on ``device``: t by an
    elementwise min, q by a float sum in shard order, flags (int32
    holding the uint32 bits) by a bitwise OR."""
    t, q, flags = (channels[0][k].to(device) for k in ('t', 'q', 'flags'))
    for c in channels[1:]:
        t = torch.minimum(t, c['t'].to(device))
        q = q + c['q'].to(device)
        flags = flags | c['flags'].to(device)
    return dict(t=t, q=q, flags=flags)


def propagate_and_daq_sharded(state, gpu_detector, seed, mesh, nchannels,
                              max_steps=100, ndaq=1, nevents=1, **fused_kw):
    """Propagation and DAQ sharded over ``mesh``: each shard propagates
    as in ``propagate_sharded`` and then digitizes its photons with
    ``ops/daq.run_daq`` on its own device, drawing its (3, ndaq, n)
    block from the same shard generator after the propagation's draws.
    The channel arrays are combined on ``mesh.devices[0]``
    (``reduce_channels``).  ``nevents`` > 1 digitizes a batch of events
    into per-event channel blocks by photon ``evidx``.  ``fused_kw``
    are ``propagate_fused``'s options.

    Returns ``(state, dict(t, q, flags))``: the propagated shards in
    order on the state's own device, and the combined channels."""
    home = state['pos'].device
    shards = _shards(state, mesh)

    def run(d):
        dev = mesh.devices[d]
        geom, det = gpu_detector.tables_on(dev)
        generator = shard_generator(seed, d, dev)
        out, _ = fused.propagate_fused(shards[d], geom,
                                       fused.uniform_draws(generator),
                                       max_steps=max_steps, **fused_kw)
        u = daq_ops.daq_draws(generator, ndaq, out['pos'].shape[0])
        return out, daq_ops.run_daq(out, geom, det, u, nchannels,
                                    ndaq=ndaq, nevents=nevents)

    outs = _map_shards(mesh, run)
    out = {k: torch.cat([o[k].to(home) for o, _ in outs]) for k in state}
    return out, reduce_channels([c for _, c in outs], mesh.devices[0])

"""Photon generation from particle vertices (counterpart of
chroma_tpu/generator/photon.py).

The reference delegates photon generation (Cherenkov + scintillation)
to Geant4 running in worker processes connected over ZeroMQ (reference:
chroma/generator/photon.py).  That architecture is kept: it is host
code (numpy only) and does not touch the device, with a pluggable
physics backend:

  * ``G4Generator`` (chroma_tpu_torch/generator/g4gen.py) when a Geant4
    python environment is present;
  * ``TrackGenerator`` (chroma_tpu_torch/generator/trackgen.py)
    otherwise: Bethe-Bloch stopping powers, Highland multiple
    scattering, analytic EM showers, Frank-Tamm Cherenkov with the
    material's dispersion, and GLG4Scint-equivalent Birks-quenched
    scintillation.

Unlike the JAX package's pool, the workers are *spawned*, not forked:
the parent usually holds a CUDA context and PyTorch's thread teams by
the time the pool starts, and a fork of such a process can hang.  A
spawned worker imports this module afresh (numpy and scipy only: nothing
on this import chain loads torch) and receives the material by pickle.
A forked worker inherits the parent's global numpy random state, which
``TrackGenerator`` draws directions from; the spawned worker is handed
that state, so from the same seeds both pools make the same photons.
"""
import multiprocessing
import os
import threading
import uuid

import numpy as np

from chroma_tpu_torch import event
from chroma_tpu_torch.sample import uniform_sphere

try:
    import zmq
    HAVE_ZMQ = True
except ImportError:
    HAVE_ZMQ = False

#: how long the pool waits for its workers' handshake before it raises
READY_TIMEOUT_S = 120.0


def unlink_ipc(address):
    """Remove the socket file of an ``ipc://`` endpoint, if there is one."""
    if address.startswith('ipc://'):
        try:
            os.unlink(address[len('ipc://'):])
        except FileNotFoundError:
            pass


def photon_bomb(n, wavelength, pos, t0=0.0):
    """An Event of n isotropic monochromatic photons from a point."""
    pos = np.tile(pos, (n, 1)).astype(np.float32)
    dir = uniform_sphere(n).astype(np.float32)
    pol = np.cross(uniform_sphere(n), dir).astype(np.float32)
    pol /= np.linalg.norm(pol, axis=1)[:, None]
    wavelengths = np.full(n, wavelength, dtype=np.float32)
    t = np.full(n, t0, dtype=np.float32)
    return event.Event(photons_beg=event.Photons(
        pos=pos, dir=dir, pol=pol, wavelengths=wavelengths, t=t))


# Physics-grade backend (Bethe-Bloch tracks, EM showers, GLG4Scint
# -equivalent scintillation); kept under the historical name.
from chroma_tpu_torch.generator.trackgen import TrackGenerator
ParametricGenerator = TrackGenerator


def _make_generator(material, seed, prefer_g4=True):
    if prefer_g4:
        try:
            from chroma_tpu_torch.generator.g4gen import G4Generator
            return G4Generator(material, seed=seed)
        except ImportError:
            pass
    return TrackGenerator(material, rng=np.random.RandomState(seed))


_spawn = multiprocessing.get_context('spawn')


class GeneratorProcess(_spawn.Process):
    """Spawned photon-generation worker fed vertices over ZMQ PULL and
    returning photon-filled events over PUSH (reference:
    chroma/generator/photon.py G4GeneratorProcess)."""

    def __init__(self, idnum, material, vertex_socket_address,
                 photon_socket_address, seed=None, tracking=False,
                 numpy_state=None):
        _spawn.Process.__init__(self)
        self.idnum = idnum
        self.material = material
        self.vertex_socket_address = vertex_socket_address
        self.photon_socket_address = photon_socket_address
        self.seed = seed
        self.tracking = tracking
        self.numpy_state = numpy_state
        self.daemon = True

    def run(self):
        if self.numpy_state is not None:
            np.random.set_state(self.numpy_state)
        gen = _make_generator(self.material, self.seed)
        context = zmq.Context()
        vertex_socket = context.socket(zmq.PULL)
        vertex_socket.connect(self.vertex_socket_address)
        photon_socket = context.socket(zmq.PUSH)
        photon_socket.connect(self.photon_socket_address)

        # ready handshake so the parent knows the world is built
        photon_socket.send_pyobj(('READY', self.idnum))

        while True:
            ev = vertex_socket.recv_pyobj()
            if self.tracking and getattr(gen, 'supports_tracking', False):
                (ev.vertices, ev.photons_beg,
                 ev.photon_parent_trackids) = gen.generate_photons(
                    ev.vertices, tracking=True)
            else:
                ev.photons_beg = gen.generate_photons(ev.vertices)
            ev.nphotons = len(ev.photons_beg)
            photon_socket.send_pyobj(ev)


class G4ParallelGenerator(object):
    """Pool of photon-generation workers (reference:
    chroma/generator/photon.py G4ParallelGenerator).  Events may come
    back out of order.  ``close()`` (also the context-manager exit and
    the finalizer) terminates the workers and closes the sockets."""

    def __init__(self, nprocesses, material, base_seed=None,
                 tracking=False):
        if not HAVE_ZMQ:
            raise ImportError('pyzmq is required for the parallel '
                              'generator pool')
        self.material = material
        if base_seed is None:
            base_seed = np.random.randint(100000000)
        base_address = 'ipc:///tmp/chroma_tpu_torch_' + uuid.uuid4().hex
        self.vertex_address = base_address + '.vertex'
        self.photon_address = base_address + '.photon'
        self.processes = []
        self.senders = []       # (thread, stop event) of generate_events
        self.zmq_context = self.vertex_socket = self.photon_socket = None
        numpy_state = np.random.get_state()
        try:
            for i in range(nprocesses):
                p = GeneratorProcess(i, material, self.vertex_address,
                                     self.photon_address,
                                     seed=base_seed + i, tracking=tracking,
                                     numpy_state=numpy_state)
                p.start()
                self.processes.append(p)

            self.zmq_context = zmq.Context()
            self.vertex_socket = self.zmq_context.socket(zmq.PUSH)
            self.vertex_socket.bind(self.vertex_address)
            self.photon_socket = self.zmq_context.socket(zmq.PULL)
            self.photon_socket.bind(self.photon_address)
        except BaseException:
            self.close()
            raise

        self.processes_initialized = False

    def _check_workers(self):
        dead = [p.idnum for p in self.processes if not p.is_alive()]
        if dead:
            raise RuntimeError('generator worker(s) %s died' % dead)

    def _wait_for_ready(self):
        if self.processes_initialized:
            return
        ready = 0
        waited_ms = 0
        while ready < len(self.processes):
            if self.photon_socket.poll(100):
                msg = self.photon_socket.recv_pyobj()
                if msg[0] != 'READY':
                    raise RuntimeError('generator worker sent %r before '
                                       'its handshake' % (msg[0],))
                ready += 1
                continue
            self._check_workers()
            waited_ms += 100
            if waited_ms > READY_TIMEOUT_S * 1000:
                raise RuntimeError('generator workers did not start '
                                   'within %g s' % READY_TIMEOUT_S)
        self.processes_initialized = True

    def generate_events(self, events):
        """Yield photon-filled events for an iterable of vertex events.
        Backpressure: at most 2 x nprocesses events in flight."""
        self._wait_for_ready()

        sem = threading.Semaphore(len(self.processes) * 2)
        sent = [0]
        stop = threading.Event()

        def sender():
            for ev in events:
                while not sem.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                # send only when the socket takes the event at once: a
                # send blocked on a dead worker would still be inside
                # libzmq when close() closes the socket from another
                # thread, and libzmq aborts the process on that
                while not self.vertex_socket.poll(100, zmq.POLLOUT):
                    if stop.is_set():
                        return
                self.vertex_socket.send_pyobj(ev)
                sent[0] += 1
            sent.append(True)  # done marker

        t = threading.Thread(target=sender)
        t.daemon = True
        self.senders.append((t, stop))
        t.start()

        received = 0
        try:
            while True:
                done = len(sent) > 1
                if done and received == sent[0]:
                    break
                # poll so we never block forever racing the done marker
                if self.photon_socket.poll(100):
                    ev = self.photon_socket.recv_pyobj()
                    received += 1
                    sem.release()
                    yield ev
                else:
                    # a dead worker would never answer: fail, do not hang
                    self._check_workers()
            t.join()
        finally:
            # on an error or an abandoned iteration, stop the sender
            self._stop_sender(t, stop)

    def _stop_sender(self, t, stop):
        stop.set()
        t.join()
        if (t, stop) in self.senders:
            self.senders.remove((t, stop))

    def close(self):
        """Stop the senders, terminate the workers and release the ipc
        sockets."""
        for t, stop in list(getattr(self, 'senders', [])):
            self._stop_sender(t, stop)
        processes = getattr(self, 'processes', [])
        for p in processes:
            if p.is_alive():
                p.terminate()
        for p in processes:
            p.join(timeout=5.0)
        self.processes = []
        for sock in (getattr(self, 'vertex_socket', None),
                     getattr(self, 'photon_socket', None)):
            if sock is not None:
                sock.close(linger=0)
        self.vertex_socket = self.photon_socket = None
        if getattr(self, 'zmq_context', None) is not None:
            self.zmq_context.term()
            self.zmq_context = None
            # libzmq leaves the files of its ipc endpoints behind
            for address in (self.vertex_address, self.photon_address):
                unlink_ipc(address)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

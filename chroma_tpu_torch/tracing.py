"""Spans and counters inside the program; off unless a recorder is set.

    from chroma_tpu_torch import tracing
    with tracing.recording() as rec:
        events = list(sim.simulate(photons, run_daq=True))
    for name, (n, total_ns, self_ns) in sorted(rec.totals().items()):
        print(name, n, total_ns / 1e6, self_ns / 1e6)

``span(name)`` times a block of host code and ``count(name, n)`` adds to
a counter.  Both look up the module attribute ``recorder`` when they are
called: while it is None (the default) ``span`` returns one shared no-op
context manager and ``count`` returns at once, so an instrumented path
costs an attribute test a span.  A span reads the host clock
(``time.perf_counter_ns``) on entry and exit and never synchronizes the
device: a span around a device op measures the host issuing it, a span
around a read of device data (``.tolist()``, ``torch.nonzero``) the host
waiting for the device.  No span is held open across a ``yield``.

While recording, each span also opens ``open_range(name)``, by default
a ``torch.profiler.record_function`` range ``chroma_tpu_torch.<name>``,
so a profiler trace shows the program's spans beside the kernels they
launch; a caller may replace ``open_range`` to name the ranges its own
way.

Spans (parents in brackets):

* ``simulate.join``, ``.upload``, ``.propagate``, ``.hits``, ``.daq``:
  ``Simulation.simulate``'s batch: joining the events' photons, the
  upload, the propagation, the flat-hit download and the DAQ;
  ``simulate.debatch``, one per event: its hits, channels and tracks;
  the first event's also holds the batch's split, done once: the flat
  hits' event bounds and one download of every event's channels;
* ``step.live`` [``simulate.propagate``]: the step loop's wait for
  the live-photon list, once a step (and the last check that finds
  none); ``step.draw``, ``step.gather``, ``step.walk``, ``step.physics``,
  ``step.scatter``: issuing a step's draws, the live rows' gather, the
  NaN guard and the walk, the physics, the scatter back (with any wait
  for the device inside them);
* ``step.reemit`` [``step.physics``]: issuing the plain
  ``physics_update``'s bulk reemission (the absorbing component, the
  reemission draws, the new wavelength, time and direction), opened only
  on the plain path (on the CPU, or for tables with a WLS, dichroic or
  thin-film surface) and only where the tables hold a reemitting
  material: the physics kernel on the card reemits inside its one
  launch;
* ``pass.wait``, ``pass.walk``, ``pass.service``: the lane-pool
  driver's host read of its chains' counts, a walker window and a
  service pass.

Counters: ``step.live_photons``, photon-steps of the step loop (the live
count each step, read on the host after the step's sync);
``step.physics_kernel_photons``, the photons of each ``physics_update``
call that the CUDA physics kernel served (the call's batch size, known
on the host: no sync; every driver's calls, the step loop's one a step);
``simulate.debatch_resorted``, batches whose flat hits came back out of
event order and were sorted once to be split (0 on every driver, which
all hand the photons back in upload order); ``simulate.reemitted``, a
batch's photons whose end flags carry ``BULK_REEMIT``, read beside the
flat-hit download only while recording and only where the tables hold a
reemitting material (one reduction and one sync a batch).
"""
import contextlib
import threading
import time

import torch

recorder = None


def open_range(name):
    """The profiler range a recorded span opens."""
    return torch.profiler.record_function('chroma_tpu_torch.' + name)


class Recorder(object):
    """What one recording keeps: ``spans``, a list of (name, parent name
    or None, start_ns, end_ns) in the order they closed, and ``counts``,
    {name: total}.  Parents follow a stack per thread."""

    def __init__(self):
        self.spans = []
        self.counts = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self):
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def totals(self):
        """{name: (count, total_ns, self_ns)}: self time is the duration
        minus that of the span's direct children."""
        out = {}
        for name, parent, start, end in self.spans:
            n, total, own = out.get(name, (0, 0, 0))
            out[name] = (n + 1, total + end - start, own + end - start)
        for name, parent, start, end in self.spans:
            if parent in out:
                n, total, own = out[parent]
                out[parent] = (n, total, own - (end - start))
        return out


class _Off(object):
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span(object):
    __slots__ = ('rec', 'name', 'parent', 'range', 'start')

    def __init__(self, rec, name):
        self.rec = rec
        self.name = name

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = open_range(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        self.rec._stack().pop()
        self.rec.spans.append((self.name, self.parent, self.start, end))
        return False


def span(name):
    """A context manager timing the block as the span ``name``."""
    rec = recorder
    if rec is None:
        return _OFF
    return _Span(rec, name)


def count(name, n):
    """Add ``n`` to the counter ``name``."""
    rec = recorder
    if rec is not None:
        with rec._lock:
            rec.counts[name] = rec.counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record into a fresh ``Recorder`` inside the block (yielded); the
    previous recorder, usually None, comes back after."""
    global recorder
    prev, recorder = recorder, Recorder()
    try:
        yield recorder
    finally:
        recorder = prev

"""Spans and counters around the program's layers, for the traced run,
and the faults the benchmark's own tests plant underneath the timed
path.

Both patch attributes of the program's modules for the length of a
``with`` block and put them back after.  The spans add no device
synchronization: a span ends when its call returns to the host.
"""
import contextlib
import functools

import torch

from portbench.trace import PREFIX


@contextlib.contextmanager
def patched(targets):
    """Replace ``(owner, attribute, wrap)`` attributes by
    ``wrap(original)`` inside the block."""
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in
             targets]
    try:
        for (owner, name, wrap), (_, _, orig) in zip(targets, saved):
            setattr(owner, name, wrap(orig))
        yield
    finally:
        for owner, name, orig in saved:
            setattr(owner, name, orig)


def span(name):
    """A record_function range ``portbench.<name>``."""
    return torch.profiler.record_function(PREFIX + name)


def spanned(name, record=None):
    """A wrapper that runs the wrapped call in the span ``name`` and
    hands ``record`` its arguments and result."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                out = fn(*args, **kwargs)
            if record is not None:
                record(args, kwargs, out)
            return out
        return inner
    return wrap


class Counters(object):
    """What the traced run counts at the program's boundaries.  A
    metric's ``instrument(counters)`` may add counters of its own as
    attributes."""

    def __init__(self):
        self.propagations = []   # (photons, steps, stats)


def nbytes(t):
    return t.numel() * t.element_size()


def targets(counters):
    """The patches (``patched``'s targets) of the traced run: spans
    around upload, propagate, daq and download, and a counter of the
    propagations.  A metric that needs spans or counters of a deeper
    layer adds them itself (its ``instrument``)."""
    from chroma_tpu_torch import gpu
    from chroma_tpu_torch.ops import daq

    def on_propagate(args, kwargs, out):
        gp = args[0]
        counters.propagations.append((len(gp), gp.last_steps,
                                      gp.last_stats))

    return [
        (gpu.GPUPhotons, '__init__', spanned('upload')),
        (gpu.GPUPhotons, 'propagate', spanned('propagate', on_propagate)),
        (gpu.GPUPhotons, 'get_flat_hits', spanned('download')),
        (daq.GPUChannels, 'get', spanned('download')),
        (daq, 'run_daq', spanned('daq')),
    ]


# ---- faults planted under the timed path (the benchmark's tests) -------

FAULTS = ('unchanged', 'half', 'altered')


def fault(kind):
    """A fault in the program for the length of the block:
    ``unchanged`` (propagation returns every photon as it came),
    ``half`` (only the first half of each batch is propagated) or
    ``altered`` (the DAQ's readout moved one channel over)."""
    from chroma_tpu_torch import gpu
    from chroma_tpu_torch.ops import daq

    def unchanged(fn):
        def inner(self, *args, **kwargs):
            self.last_steps, self.last_stats = 0, None
        return inner

    def half(fn):
        def inner(self, *args, **kwargs):
            full = self.state
            m = len(self) // 2
            self.state = {k: v[:m] for k, v in full.items()}
            out = fn(self, *args, **kwargs)
            self.state = {k: torch.cat([self.state[k], full[k][m:]])
                          for k in full}
            return out
        return inner

    def altered(fn):
        def inner(*args, **kwargs):
            out = fn(*args, **kwargs)
            return {k: torch.roll(v, 1) for k, v in out.items()}
        return inner

    if kind == 'altered':
        return patched([(daq, 'run_daq', altered)])
    return patched([(gpu.GPUPhotons, 'propagate',
                     {'unchanged': unchanged, 'half': half}[kind])])

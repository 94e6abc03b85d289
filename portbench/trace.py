"""Reading a ``torch.profiler`` trace of the measured window.

Spans are ``record_function`` ranges named ``portbench.<name>``: the
window itself, each call, and the program's upload, propagate, daq and
download, which the traced run wraps (``spans.py``).  Device time is
the union of every device operation's interval inside the window;
idle time is the rest of the window, each gap put down to the innermost
span open at its midpoint.
"""
import collections

import numpy as np
import torch

PREFIX = 'portbench.'
WINDOW = PREFIX + 'window'


def _raw_events(prof):
    """(name, on_device, start_ns, end_ns) of every event."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    if events is not None:
        for e in events:
            if hasattr(e, 'start_ns'):
                start, dur = e.start_ns(), e.duration_ns()
            else:
                start, dur = e.start_us() * 1000, e.duration_us() * 1000
            out.append((e.name(), e.device_type() == cuda, start,
                        start + dur))
        return out
    for e in prof.events():
        out.append((e.name, e.device_type == cuda,
                    e.time_range.start * 1000, e.time_range.end * 1000))
    return out


def summarize(prof):
    """dict(window_s, busy_s, kernels {name: s}, idle {span: s},
    device_ops and idle_gaps: the ten largest of each)."""
    events = _raw_events(prof)
    spans = [(n, s, e) for n, dev, s, e in events
             if not dev and n.startswith(PREFIX)]
    windows = [(s, e) for n, s, e in spans if n == WINDOW]
    if not windows:
        raise RuntimeError('the trace holds no %s span' % WINDOW)
    w0, w1 = windows[0]
    kernels = collections.Counter()
    starts, ends = [], []
    for name, dev, s, e in events:
        if not dev or name.startswith(PREFIX):
            continue
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        starts.append(s)
        ends.append(e)
        kernels[name] += (e - s) / 1e9
    # the union of the device intervals, and the gaps between them
    order = np.argsort(np.asarray(starts, dtype=np.int64), kind='stable')
    s = np.asarray(starts, dtype=np.int64)[order]
    e = np.maximum.accumulate(np.asarray(ends, dtype=np.int64)[order]) \
        if len(order) else np.zeros(0, np.int64)
    prev = np.concatenate([[w0], e[:-1]]) if len(e) else np.zeros(0, np.int64)
    last = e[-1] if len(e) else w0
    gap0 = np.concatenate([prev, [last]])
    gap1 = np.concatenate([s, [w1]])
    keep = gap1 > gap0
    gap0, gap1 = gap0[keep], gap1[keep]
    window = w1 - w0
    busy_s = (window - (gap1 - gap0).sum()) / 1e9
    # each gap goes to the innermost span open at its midpoint
    inner = sorted(((sp_e - sp_s, sp_s, sp_e, n[len(PREFIX):])
                    for n, sp_s, sp_e in spans if n != WINDOW),
                   reverse=True)
    names = ['outside_any_span'] + [n for _, _, _, n in inner]
    label = np.zeros(len(gap0), dtype=np.int64)
    mids = (gap0 + gap1) / 2.0
    mid_order = np.argsort(mids)
    sorted_mids = mids[mid_order]
    for k, (_, sp_s, sp_e, _) in enumerate(inner, start=1):
        a, b = np.searchsorted(sorted_mids, [sp_s, sp_e])
        label[mid_order[a:b]] = k
    idle = collections.Counter()
    for k, v in enumerate(np.bincount(label, weights=(gap1 - gap0) / 1e9,
                                      minlength=len(names))):
        if v > 0:
            idle[names[k]] += float(v)
    return dict(window_s=window / 1e9, busy_s=float(busy_s),
                kernels=dict(kernels), idle=dict(idle), events=len(events),
                device_ops=[[n, v] for n, v in kernels.most_common(10)],
                idle_gaps=[[n, v] for n, v in idle.most_common(10)])


def kernel_seconds(summary, names):
    """Device seconds of every kernel whose name holds one of ``names``."""
    return sum(s for k, s in summary['kernels'].items()
               if any(n in k for n in names))

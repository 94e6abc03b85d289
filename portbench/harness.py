"""One run of one benchmark cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything a cell is made of is found by name, and nothing here names a
configuration, a traffic mix, an entry, a check or a metric:

* its entry in ``BENCHMARK.json``;
* the configuration's file, ``configs/<name>.json``, whose ``module``
  loads the program's tables (``load``) and holds the plain reference
  (``reference``), and may plant faults in the tables (``FAULTS``);
* the traffic mix, ``traffic/<name>.json``: its ``source`` kind makes the
  input bank (``sources/<kind>.py``, through ``generator.py``), its
  ``entry`` drives the program (``entries/<entry>.py``), its ``rate``
  names the end-to-end metric the entry's units of work feed, and its
  ``trace_seconds`` how much of the window a traced run traces;
* the check's limits, ``limits/<cell>.json``: the ``check`` module
  (``compare(reference, samples, device)``) and each number it returns
  that is compared, with its limit;
* each per-layer metric, ``metrics/<name>.py``: ``read(ctx)`` and, where
  it needs a counter of its own, ``instrument(counters)``.

A run sets up (tables, the input bank, one warm-up call at the cell's
shapes), calls the entry back to back for ``--seconds``, checks a sample
of what the window produced against the reference, and prints one JSON
line last on standard output.  A rate is all the units of work of the
calls that finished over the time from the window's start to the end of
the last of them.  With ``--trace 1`` the first calls of the window, up
to the first to end past ``trace_seconds``, run under ``torch.profiler``
with spans around the program's layers, the rest of the window without
it, both with counters at the program's boundaries, and the line holds
the per-layer metrics: ``read(ctx)`` gets ``ctx['traced']`` and
``ctx['rest']`` (each the part's ``window_s``, ``work``, ``calls`` and
``counters``; ``rest`` None where the trace took the whole window) and
``ctx['trace']``, the trace's summary (``trace.summarize``).
"""
import argparse
import contextlib
import json
import os
import sys
import time
import traceback

import torch

from portbench import generator, plugins, spans
from portbench import trace as trace_mod

BENCH_DIR = plugins.BENCH_DIR
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, '.cache')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'chroma_tpu')
# the window's clock (the tests give it one of their own)
clock = time.perf_counter


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell(object):
    """A workload of the manifest with every file it is made of."""

    def __init__(self, name, manifest_path=None):
        manifest_path = manifest_path or os.path.join(ROOT,
                                                      'BENCHMARK.json')
        self.manifest = load_json(manifest_path)
        base = os.path.dirname(os.path.abspath(manifest_path))
        cells = {w['name']: w for w in self.manifest['workloads']}
        if name not in cells:
            raise KeyError('no workload %r in %s' % (name, manifest_path))
        self.name = name
        self.workload = cells[name]
        configs = {c['name']: c for c in self.manifest['configs']}
        self.config_entry = configs[self.workload['config']]
        self.config = load_json(os.path.join(base,
                                             self.config_entry['file']))
        bench = os.path.join(base, 'portbench')
        self.bench = bench
        self.config_module = plugins.load(os.path.join(
            bench, self.config['module']))
        self.traffic = load_json(os.path.join(
            bench, 'traffic', self.workload['traffic'] + '.json'))
        self.entry_module = plugins.find(bench, 'entries',
                                         self.traffic['entry'])
        self.limits = load_json(os.path.join(bench, 'limits',
                                             name + '.json'))
        self.check_module = plugins.load(os.path.join(
            bench, self.limits['check']))
        self.end_to_end = [m for m in self.manifest['end_to_end']
                           if name in m.get('workloads', [name])]
        self.per_layer = [m for m in self.manifest['per_layer']
                          if name in m.get('workloads', [name])]

    def metric_reader(self, name):
        return plugins.find(self.bench, 'metrics', name)


def forbidden_modules():
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(cell, seed, seconds, trace=False, device=None, mode=None,
        t_process=None, log=sys.stderr):
    """Run ``cell`` once; returns the result dict.  ``mode`` plants a
    fault: one of the program's (``spans.fault``) or of the
    configuration's tables (its module's ``FAULTS``); ``control`` hands
    the check the outputs in the entry's lower precision."""
    t_process = time.time() if t_process is None else t_process
    dev = torch.device(device or 'cuda')
    cuda = dev.type == 'cuda'
    seeds = generator.stream_seeds(seed)
    traffic, cfg = cell.traffic, cell.config
    table_faults = getattr(cell.config_module, 'FAULTS', {})
    os.makedirs(CACHE_DIR, exist_ok=True)

    gg = cell.config_module.load(cfg, dev, CACHE_DIR)
    if mode in table_faults:
        gg = table_faults[mode](gg, cfg)
    bank = generator.make_bank(traffic['source'], cfg, seeds['bank'], dev,
                               bench=cell.bench)
    entry = cell.entry_module.Entry(gg, traffic, bank, seeds, dev)

    faults = spans.fault(mode) if mode in spans.FAULTS \
        else spans.patched([])
    with faults, contextlib.ExitStack() as counting:
        entry.call(entry.next()[0])         # warm-up at the cell's shapes
        if cuda:
            torch.cuda.synchronize(dev)
        setup_s = time.time() - t_process

        tracing = contextlib.ExitStack()
        prof = part = traced = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            part = _Part(cell)
            prof.start()
            tracing.enter_context(spans.patched(part.targets))
            tracing.enter_context(spans.span('window'))
        trace_seconds = traffic['trace_seconds']
        calls, durations, failed, work = [], [], 0, 0
        t0 = clock()
        t_end = t0
        if part is not None:
            part.t0 = part.t_end = t0
        paused = 0.0       # the profiler's own stop, outside the window
        while clock() - t0 - paused < seconds:
            args, units = entry.next()
            try:
                with spans.span('call'):
                    out = entry.call(args)
            except Exception:
                failed += 1
                traceback.print_exc(file=log)
                break
            durations.append(clock() - t_end)
            t_end = clock()
            calls.append((args, out))
            work += units
            if part is not None:
                part.add(units, t_end)
            if prof is not None and traced is None \
                    and t_end - t0 >= trace_seconds:
                tracing.close()
                prof.stop()
                traced, part = part, _Part(cell)
                counting.enter_context(spans.patched(part.targets))
                paused += part.t0 - t_end
                t_end = part.t0
        window_s = t_end - t0 - paused
        if prof is not None and traced is None:
            tracing.close()
            prof.stop()
            traced, part = part, None
    attempted = len(calls) + failed
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    result = dict(correct=False, attempted=attempted, failed=failed)
    values = {traffic['rate']: work / window_s if window_s else 0.0,
              'setup_s': setup_s}
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m['name'] not in values:
                raise KeyError('%s reports no %s: its traffic feeds %s'
                               % (cell.name, m['name'], traffic['rate']))
            metrics[m['name']] = dict(value=values[m['name']],
                                      unit=m['unit'])
    device_info = dict(platform='gpu' if cuda else dev.type,
                       kind=torch.cuda.get_device_name(dev) if cuda
                       else 'cpu', count=1, memory_peak_bytes=memory_peak)
    breakdown = None
    if trace:
        t_read = time.time()
        summary = trace_mod.summarize(prof)
        del prof
        print('portbench: a trace of %d events read in %.1f s'
              % (summary['events'], time.time() - t_read), file=log)
        device_info.update(busy_s=summary['busy_s'],
                           window_s=summary['window_s'])
        rest = part.summary() if part is not None and part.calls else None
        ctx = dict(traced=traced.summary(), rest=rest, trace=summary)
        for m in cell.per_layer:
            value = cell.metric_reader(m['name']).read(ctx)
            if value is not None:
                metrics[m['name']] = dict(value=value, unit=m['unit'])
        breakdown = dict(device_ops=summary['device_ops'],
                         idle_gaps=summary['idle_gaps'])

    # the program's state goes before the reference runs on the device
    samples = entry.samples(calls, traffic.get('check_events', 3),
                            seeds['check'])
    entry.close()
    del entry, gg, calls
    if cuda:
        torch.cuda.empty_cache()
    if mode == 'control':
        samples = [cell.entry_module.Entry.lower_precision(x)
                   for x in samples]
    ref = cell.config_module.reference(cfg, dev)
    readings = cell.check_module.compare(ref, samples, dev)
    checks = {name: dict(value=readings[name], limit=spec['limit'])
              for name, spec in cell.limits['numbers'].items()}
    correct = failed == 0 and attempted > 0 and all(
        c['value'] <= c['limit'] for c in checks.values())
    found = forbidden_modules()
    result.update(correct=correct, metrics=metrics, device=device_info)
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = checks
    result['_counts'] = dict(readings.get('counts', {}), call_s=durations)
    result['_forbidden'] = found
    return result


class _Part(object):
    """A part of a traced run's window: the traced calls, under the
    profiler, or the rest, without it.  Both count at the program's
    boundaries; a per-layer metric reads a host time only from the rest,
    which the profiler does not slow."""

    def __init__(self, cell):
        self.counters = spans.Counters()
        self.targets = spans.targets(self.counters)
        for m in cell.per_layer:
            reader = cell.metric_reader(m['name'])
            if hasattr(reader, 'instrument'):
                self.targets += reader.instrument(self.counters)
        self.t0 = self.t_end = clock()
        self.work = self.calls = 0

    def add(self, units, t_end):
        self.work += units
        self.calls += 1
        self.t_end = t_end

    def summary(self):
        return dict(window_s=self.t_end - self.t0, work=self.work,
                    calls=self.calls, counters=self.counters)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_process=None):
    args = parse_args(argv)
    cell = Cell(args.workload)
    chips = cell.workload['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('portbench: %s needs %d CUDA device(s); %d available'
              % (args.workload, chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, trace=bool(args.trace),
                 t_process=t_process)
    return report(result)


def report(result, out=sys.stdout, err=sys.stderr):
    """Print the compared numbers last on standard error and the result
    line last on standard output; a run that loaded JAX or the JAX
    package prints no result."""
    counts = result.pop('_counts')
    found = result.pop('_forbidden')
    if found:
        print('portbench: the process holds %s; no result'
              % ', '.join(found), file=err)
        return 3
    print('portbench: check counts %s' % json.dumps(counts), file=err)
    for name, c in result['checks'].items():
        print('portbench: %s %r limit %r' % (name, c['value'], c['limit']),
              file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0

"""Split a benchmark cell's ``Entry.call`` by the program's spans, and
count its CUDA syncs by the span they happen in, on one NVIDIA card.

    python tools/span_split.py <cell> <seed> [calls]

Run from the root of a checkout (the program and portbench of that
checkout are used, and its portbench/.cache).  The cell is built as
portbench/run.py builds it, one call warms it up, then:

* ``calls`` calls (default 3), each with a recorder on and no profiler:
  the host ms of each call between device syncs, and per span its total
  ms a call, its share of the call and how often it opened, and the
  counters;
* one more call with ``torch.cuda.set_sync_debug_mode('warn')``: every
  sync PyTorch reports, counted by the innermost open span ("(none)"
  outside every span).

Prints one JSON line for each.  A sync that PyTorch does not see (a
ctypes launch, ``torch.cuda.synchronize``) is not counted.
"""
import collections
import json
import os
import sys
import time
import warnings

ROOT = os.getcwd()
os.environ['CHROMA_TPU_CACHE'] = os.path.join(ROOT, 'portbench', '.cache',
                                              'chroma_tpu')
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chroma_tpu_torch import tracing  # noqa: E402
from portbench import generator, harness  # noqa: E402


def build(cell_name, seed, dev):
    cell = harness.Cell(cell_name)
    seeds = generator.stream_seeds(seed)
    gg = cell.config_module.load(cell.config, dev, harness.CACHE_DIR)
    bank = generator.make_bank(cell.traffic['source'], cell.config,
                               seeds['bank'], dev, bench=cell.bench)
    return cell.entry_module.Entry(gg, cell.traffic, bank, seeds, dev)


def split(entry, ncalls):
    walls, totals = [], collections.Counter()
    opened, counts = collections.Counter(), collections.Counter()
    for _ in range(ncalls):
        ids, _ = entry.next()
        with tracing.recording() as rec:
            t0 = time.perf_counter()
            entry.call(ids)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        for name, (n, total_ns, _) in rec.totals().items():
            totals[name] += total_ns / 1e6 / ncalls
            opened[name] += n
        counts.update(rec.counts)
    call_ms = sum(walls) / ncalls * 1e3
    return dict(call_ms=call_ms, calls_ms=[w * 1e3 for w in walls],
                spans={k: [round(v, 2), round(100 * v / call_ms, 2),
                           opened[k]] for k, v in sorted(totals.items())},
                counters=dict(counts))


def sync_census(entry):
    syncs = collections.Counter()
    with tracing.recording() as rec, warnings.catch_warnings():
        def show(message, category, filename, lineno, file=None,
                 line=None):
            stack = rec._stack()
            syncs[stack[-1] if stack else '(none)'] += 1
        warnings.simplefilter('always')
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode('warn')
        try:
            entry.call(entry.next()[0])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return dict(syncs)


def main():
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    cell_name, seed = sys.argv[1], int(sys.argv[2])
    ncalls = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    if not torch.cuda.is_available():
        raise SystemExit('needs an NVIDIA card')
    entry = build(cell_name, seed, torch.device('cuda'))
    try:
        entry.call(entry.next()[0])
        torch.cuda.synchronize()
        print(json.dumps(dict(root=ROOT, cell=cell_name, seed=seed,
                              **split(entry, ncalls))), flush=True)
        print(json.dumps(dict(root=ROOT, cell=cell_name,
                              syncs=sync_census(entry))), flush=True)
    finally:
        entry.close()


if __name__ == '__main__':
    main()

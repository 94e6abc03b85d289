"""Time the K5 window kernel of this tree against the parent's, alternated.

    python tools/ab_window_k5.py --parent DIR [--rounds 1]
    python tools/ab_window_k5.py --measure --tree DIR

Needs one NVIDIA card and the table cache that ``python3 chip_smoke.py``
fills (``CHROMA_TPU_CACHE``, by default .cache/chroma_tpu in this
checkout, as chip_smoke.py sets it): the full demo's tables ``full``
and the SNO-like detector's ``sno_like_9438``.  The first form builds
a missing one the way chip_smoke.py does (~1 and ~2 min of host time).

The first form runs the second once per tree, in the order P C L L C P
(``--rounds`` times): P is DIR, an unpacked ``git archive`` of the
parent commit; C this tree; L a copy of this tree under .cache/ab_k5/
with ``LIST_PATCH`` applied, the design that was tried and not kept: a
first kernel lists the lanes not drained and the persistent warps take
only those.  It prints (and writes to chiprun_out/ab_window_k5.json)
each shape's mean times per tree and their ratio to P.

The second form, in a fresh process with DIR's ``chroma_tpu_torch`` on
the path, calls ``ops.mbvh_walk.walk_window_cuda`` (both trees have it)
without on-deck slots, the entry-code scale and the seed arguments
computed before (each is a host sync), at the shapes of PERF.md: the
full demo at 65,536 lanes x 17 iterations,
pruning and not (K5, K6 on K5); the SNO-like flat table at 65,536 x 17;
the full demo at 17 with a third of the lanes drained at entry; one
iteration over 65,536 full-demo lanes from the state 8 iterations in
(the ``service_frac`` launch) and from one in which every walk has
drained.  Each shape starts from a seeded state (``random_window_state``)
and is held bit-equal to the plain version with an equal active count.
Then, after a warm-up, each of ``REPS`` windows on its own copy of the
state: ``device_ms``, the device time of every kernel, memset and copy
the windows ran (CUPTI, ``torch.profiler``) over REPS, with each one's
share; and ``span_ms``, three times the time between two CUDA events
around the REPS windows, enqueued while the card sleeps
(``torch.cuda._sleep``), over REPS: the gaps between a window's
launches included.  Last, 1,048,576 isotropic photons through the
driver without on-deck slots (``ondeck=False``, generator seed 1, after
a warm-up at seed 0): photons/s, service passes, photon-steps and wall
a pass.  It prints one JSON line.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 65536
SERVICE_EVERY = 17
ITER1_AFTER = 8         # iterations before the one-iteration launch
DRAIN_AFTER = 400       # iterations: every walk has drained
REPS = 20               # timed windows a shape
SLEEP_CYCLES = 20000000  # ~10 ms of a busy card while the host enqueues
NPHOTONS = 1 << 20
DEVICE = 'cuda:0'
K5_SOURCE = os.path.join('chroma_tpu_torch', 'csrc',
                         'mbvh_walk_window_k5.cu')
WRAPPER = os.path.join('chroma_tpu_torch', 'ops', 'mbvh_walk.py')

# The live-lane list: (file, text, replacement), each text found once.
LIST_PATCH = (
    (K5_SOURCE, '// Lanes 0..n-1 from the queue', '''\
constexpr int LIVE_BLOCK = 256;
constexpr int LIST_AT = 32;     // the list's first word: its own line

// The lanes not drained, listed in queue[LIST_AT..], their number in
// queue[1] (zero before).
__global__ void __launch_bounds__(LIVE_BLOCK)
k5_live_lanes(const uint8_t* __restrict__ act,
              const int32_t* __restrict__ lvl, int n,
              unsigned* __restrict__ queue) {
    const unsigned i = blockIdx.x * LIVE_BLOCK + threadIdx.x;
    const bool on = i < (unsigned)n && (act[i] != 0 || lvl[i] >= 0);
    const unsigned mask = __ballot_sync(FULL, on);
    if (mask == 0) return;
    const int t = lane_id();
    unsigned first = 0;
    if (t == 0) first = atomicAdd(queue + 1, (unsigned)__popc(mask));
    first = __shfl_sync(FULL, first, 0);
    if (on) queue[LIST_AT + first + __popc(mask & ((1u << t) - 1u))] = i;
}

// Lanes 0..n-1 from the queue'''),
    (K5_SOURCE, '    unsigned long long nact = 0;\n    for (;;) {\n', '''\
    const unsigned nlive = queue[1];
    unsigned long long nact = 0;
    for (;;) {
'''),
    (K5_SOURCE, '        if (k >= (unsigned)n) break;\n', '''\
        if (k >= nlive) break;
        k = queue[LIST_AT + k];
'''),
    (K5_SOURCE, '''\
    cudaError_t e = cudaMemsetAsync(q, 0, sizeof(unsigned), s);
    if (e != cudaSuccess) return (int)e;
''', '''\
    cudaError_t e = cudaMemsetAsync(q, 0, 2 * sizeof(unsigned), s);
    if (e != cudaSuccess) return (int)e;
    k5_live_lanes<<<(n + LIVE_BLOCK - 1) / LIVE_BLOCK, LIVE_BLOCK, 0, s>>>(
        static_cast<const uint8_t*>(st.p[ACT]),
        static_cast<const int32_t*>(st.p[LVL]), n, q);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
'''),
    (WRAPPER, 'queue = torch.empty(1, dtype=torch.int32, device=dev)',
     'queue = torch.empty(n + 32, dtype=torch.int32, device=dev)'),
)


def card():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---- the second form: one tree, in its own process ---------------------

def measure(tree):
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chroma_tpu_torch
    from chroma_tpu_torch import benchmark, gpu
    from chroma_tpu_torch.ops import mbvh as tmbvh, mbvh_walk
    from chroma_tpu_torch.ops.table_cache import load_tables
    assert os.path.dirname(os.path.abspath(chroma_tpu_torch.__file__)) \
        == os.path.join(os.path.abspath(tree), 'chroma_tpu_torch')
    if not torch.cuda.is_available():
        sys.exit('no CUDA card')
    dev = torch.device(DEVICE)
    tables = {}
    for name in ('full', 'sno_like_9438'):
        hit = load_tables(name, dev)
        if hit is None:
            sys.exit('table cache %r missing: run chip_smoke.py first'
                     % name)
        tables[name] = hit[0]
    # the seed arguments once a table: root_seed_args syncs the host
    roots = {id(g): mbvh_walk.root_seed_args(g) for g in tables.values()}

    def clone(W):
        return mbvh_walk.window_layout({k: v.clone() for k, v in W.items()})

    def window(g, W, iters, prune, sq, plain=False, nactive=None):
        walk = mbvh_walk.walk_window_plain if plain \
            else mbvh_walk.walk_window_cuda
        return walk(g.mbvh_rows, W, iters, int(g.mbvh_depth),
                    bool(g.mbvh_instanced), sq, 0, *roots[id(g)],
                    prune=prune, nactive=nactive)

    def state(g, sq, advance, third):
        W = mbvh_walk.random_window_state(
            g.mbvh_rows, int(g.mbvh_depth), bool(g.mbvh_instanced), sq,
            WIDTH, 0, 17)
        if third:
            done = window(g, clone(W), DRAIN_AFTER, True, sq, plain=True)
            lanes = torch.arange(WIDTH, device=dev) % 3 == 0
            W = mbvh_walk.window_layout({
                k: torch.where(lanes.view((WIDTH,) + (1,) * (v.dim() - 1)),
                               done[k], v) for k, v in W.items()})
        if advance:
            window(g, W, advance, True, sq, plain=True)
        return W

    def span(g, W0, iters, prune, sq):
        """Event ms of REPS windows back to back, each on its own copy
        of W0, enqueued while the card sleeps, over REPS."""
        copies = [clone(W0) for _ in range(REPS)]
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for W in copies:
            window(g, W, iters, prune, sq)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / REPS

    def profiled(g, W0, iters, prune, sq):
        """Device ms a window of each kernel, memset or copy that ran in
        REPS windows (CUPTI through torch.profiler): {name: (count, ms a
        window)}."""
        copies = [clone(W0) for _ in range(REPS)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for W in copies:
                window(g, W, iters, prune, sq)
            torch.cuda.synchronize()
        return {e.key[:60]: (e.count, e.self_device_time_total / 1e3 / REPS)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    out = {'tree': tree, 'card': card(), 'shapes': {}}
    shapes = (('full_k5_17', 'full', SERVICE_EVERY, True, 0, False),
              ('full_k6_17', 'full', SERVICE_EVERY, False, 0, False),
              ('sno_k5_17', 'sno_like_9438', SERVICE_EVERY, True, 0, False),
              ('full_k5_17_third_drained', 'full', SERVICE_EVERY, True, 0,
               True),
              ('full_k5_1', 'full', 1, True, ITER1_AFTER, False),
              ('full_k5_1_drained', 'full', 1, True, DRAIN_AFTER, False))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for label, name, iters, prune, advance, third in shapes:
        g = tables[name]
        sq = tmbvh.tquant_scale(g)
        W0 = state(g, sq, advance, third)
        k, p = clone(W0), clone(W0)
        ck = torch.zeros((), dtype=torch.int64, device=dev)
        cp = torch.zeros_like(ck)
        window(g, k, iters, prune, sq, nactive=ck)
        window(g, p, iters, prune, sq, plain=True, nactive=cp)
        bad = [key for key in k if not torch.equal(bits(k[key]),
                                                   bits(p[key]))]
        if bad or int(ck) != int(cp):
            sys.exit('%s: kernel differs from plain in %s, nactive %d vs '
                     '%d' % (label, bad, int(ck), int(cp)))
        span(g, W0, iters, prune, sq)                  # warm-up
        spans = [span(g, W0, iters, prune, sq) for _ in range(3)]
        ops = profiled(g, W0, iters, prune, sq)
        walking = int((W0['act'] | (W0['lvl'] >= 0)).sum())
        out['shapes'][label] = dict(
            device_ms=sum(ms for _, ms in ops.values()), ops=ops,
            span_ms=sum(spans) / len(spans), spans=spans, lanes=WIDTH,
            lanes_not_drained=walking, iterations=iters, prune=prune,
            nactive=int(ck))
        del W0, k, p

    gg = gpu.GPUDetector.from_table_cache('full', device=dev)
    photons = benchmark._isotropic_photons(NPHOTONS)
    for seed in (0, 1):
        counter = mbvh_walk.walk_window_launches[0]
        counter.reset()
        gp = gpu.GPUPhotons(photons, dev)
        rng = gpu.get_rng_states(seed=seed, device=dev)
        torch.cuda.synchronize()
        t0 = time.time()
        gp.propagate(gg, rng, max_steps=100, ondeck=False,
                     collect_stats=True)
        torch.cuda.synchronize()
        secs = time.time() - t0
    st = [int(x) for x in gp.last_stats]
    out['driver'] = dict(
        mode='ondeck=False', seed=1, photons=NPHOTONS,
        photons_per_s=NPHOTONS / secs, seconds=secs, passes=st[0],
        photon_steps=st[1], wall_ms_per_pass=secs * 1e3 / st[0],
        k5_launches=counter.launches)
    print(json.dumps(out), flush=True)


# ---- the first form: the trees, alternated ------------------------------

def list_tree():
    """A copy of this tree's package under .cache/ab_k5/list with
    LIST_PATCH applied."""
    tree = os.path.join(ROOT, '.cache', 'ab_k5', 'list')
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, 'chroma_tpu_torch'),
                    os.path.join(tree, 'chroma_tpu_torch'),
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    for path, text, new in LIST_PATCH:
        path = os.path.join(tree, path)
        with open(path) as f:
            src = f.read()
        if src.count(text) != 1:
            sys.exit('LIST_PATCH: %r found %d times in %s'
                     % (text[:40], src.count(text), path))
        with open(path, 'w') as f:
            f.write(src.replace(text, new))
    return tree


def run_tree(tree, env):
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), '--measure', '--tree',
         tree], capture_output=True, text=True, env=env, timeout=900)
    if proc.returncode != 0:
        sys.exit('measure in %s failed (%d):\n%s\n%s'
                 % (tree, proc.returncode, proc.stdout[-4000:],
                    proc.stderr[-4000:]))
    return json.loads(proc.stdout.strip().splitlines()[-1])


def prepare(env):
    """Build and save the table cache entries the measurement reads and
    the cache lacks, the way chip_smoke.py does (its functions)."""
    os.environ['CHROMA_TPU_CACHE'] = env['CHROMA_TPU_CACHE']
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke
    from chroma_tpu_torch import gpu
    from chroma_tpu_torch.ops.table_cache import load_tables
    dev = torch.device(DEVICE)
    if load_tables('full', dev) is None:
        chip_smoke.full_detector(dev)
    name = 'sno_like_%d' % chip_smoke.SNO_NPMT
    if load_tables(name, dev) is None:
        gdml, ratdb = chip_smoke.sno_like_gdml(
            chip_smoke.SNO_NPMT, os.path.join(
                ROOT, '.cache', 'sno', 'sno_%d.gdml' % chip_smoke.SNO_NPMT))
        loader = chip_smoke.RATGeoLoader(gdml, ratdb_file=ratdb)
        loader.add_pmt_info()
        det = chip_smoke.sno_detector(loader)
        det.flatten()
        gpu.GPUDetector(det, dev).save_table_cache(name)
    torch.cuda.synchronize()


def ab(parent, rounds, out_path):
    env = dict(os.environ)
    env.setdefault('CHROMA_TPU_CACHE',
                   os.path.join(ROOT, '.cache', 'chroma_tpu'))
    t0 = time.time()
    prepare(env)
    print('tables ready in %.0f s' % (time.time() - t0), flush=True)
    trees = {'P': os.path.abspath(parent), 'C': ROOT, 'L': list_tree()}
    names = ['P', 'C', 'L']
    order = (names + names[::-1]) * rounds
    runs = {name: [] for name in names}
    for name in order:
        run = run_tree(trees[name], env)
        runs[name].append(run)
        print('%s: device ms %s; span ms %s; driver %s (%.0f s)'
              % (name, {k: round(v['device_ms'], 4)
                        for k, v in run['shapes'].items()},
                 {k: round(v['span_ms'], 4)
                  for k, v in run['shapes'].items()},
                 {k: run['driver'][k] for k in
                  ('photons_per_s', 'passes', 'photon_steps',
                   'wall_ms_per_pass', 'k5_launches')},
                 time.time() - t0), flush=True)
    shapes = list(runs['P'][0]['shapes'])
    summary = {}
    for name in names:
        row = {}
        for shape in shapes:
            row[shape] = {}
            for key in ('device_ms', 'span_ms'):
                means = [r['shapes'][shape][key] for r in runs[name]]
                row[shape][key] = sum(means) / len(means)
                row[shape]['runs_' + key] = means
        row['driver'] = {key: [r['driver'][key] for r in runs[name]]
                         for key in ('photons_per_s', 'wall_ms_per_pass',
                                     'passes', 'photon_steps')}
        summary[name] = row
    for key in ('device_ms', 'span_ms'):
        for name in names:
            print('%s %s %s' % (key, name, '  '.join(
                '%s %.4f ms (%.3fx P)' % (
                    shape, summary[name][shape][key],
                    summary[name][shape][key] / summary['P'][shape][key])
                for shape in shapes)))
    line = {'ab_window_k5': summary, 'order': order, 'card': card(),
            'reps': REPS}
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, 'w') as f:
        json.dump({'line': line, 'runs': runs}, f)
    print(json.dumps(line), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', help='unpacked git archive of the parent')
    ap.add_argument('--rounds', type=int, default=1)
    ap.add_argument('--measure', action='store_true')
    ap.add_argument('--tree', default=ROOT)
    ap.add_argument('--out', default=os.path.join(
        ROOT, 'chiprun_out', 'ab_window_k5.json'))
    args = ap.parse_args()
    if args.measure:
        measure(args.tree)
    elif args.parent:
        ab(args.parent, args.rounds, args.out)
    else:
        ap.error('give --parent DIR or --measure')


if __name__ == '__main__':
    main()

"""Run the PyTorch/CUDA port's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles chroma_tpu_torch/csrc/*.cu with nvcc, one process
     per source, all started together;
  3. the closest-hit walker kernel against its plain PyTorch version on
     the card (flat sphere, instanced demo.tiny, last-hit/active, ragged
     widths, 500,000 center rays in the full demo): equal triangles and
     material codes, bit-equal distances and normals, and both times;
  4. the on-deck window kernel (K3, K4) against its plain version: flat
     sphere, demo.tiny and the full demo, od_slots 1 and 2, a ragged
     width; a service window and a long window in which every walk
     drains; every state field bit-equal; both times at full-demo width;
  5. the whole on-deck driver on demo.tiny, window kernel against plain
     walker, same generator seed: final photons bit-equal; referee
     check 1 (terminal passthrough) bit-exact on the full demo;
  6. the main path: full demo tables from the table cache (built and
     saved on a miss); 500,000 center rays through ``intersect_mesh``;
     1,048,576 photons through ``GPUPhotons.propagate`` on the on-deck
     driver (od_slots 1: one warm-up, three timed runs; od_slots 2: one
     warm-up, one timed run) and on the step loop (one warm-up, three
     timed runs); >= 99% of photons must end terminal in each;
  7. full-demo physics (on-deck driver) against
     tests/golden/demo_full_pdf.npz;
  8. ``Simulation.simulate(run_daq=True)`` on demo.tiny through both
     drivers, pooled, against tests/golden/demo_tiny_pdf.npz and against
     each other.
The line before the last is a JSON summary of every kernel; the last is
{"ok": true, "device": {...}}.  Caches go under .cache/ in the checkout.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
os.environ.setdefault('CHROMA_TPU_CACHE',
                      os.path.join(ROOT, '.cache', 'chroma_tpu'))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chroma_tpu_torch import _build, benchmark, gpu, host  # noqa: E402
from chroma_tpu_torch import referee  # noqa: E402
from chroma_tpu_torch.ops import fused  # noqa: E402
from chroma_tpu_torch.ops import mbvh as tmbvh, mbvh_walk  # noqa: E402
from chroma_tpu_torch.ops.geometry_pack import pack_geometry  # noqa: E402
from chroma_tpu_torch.ops.propagate import TERMINAL, i32  # noqa: E402
from chroma_tpu_torch.sim import Simulation  # noqa: E402
from tools import golden_config as G  # noqa: E402

GOLDEN_DIR = os.path.join(ROOT, 'tests', 'golden')
NRAYS = 500000          # benchmark.intersect's batch
NPHOTONS = 1 << 20      # bench.py's batch
NDRIVER = 65536         # photons of the driver's kernel-against-plain run
LONG_WINDOW = 4096      # iterations: every walk drains well before


def check(ok, what):
    if not ok:
        raise SystemExit('chip_smoke FAILED: %s' % what)


def chi2_ndf(a, b):
    """chi^2/ndf between two Poisson histograms (tests/test_golden.py)."""
    err2 = a + b
    use = err2 > 0
    return float(np.sum((a[use] - b[use]) ** 2 / err2[use])
                 / max(use.sum(), 1))


def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over reps runs (after one)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_walk(tables, org, dirv, dev, lht=None, active=None):
    """Kernel vs plain version on the same card tensors.  Returns
    (number of hits, max abs difference of distance and normal)."""
    n = len(org)
    o = torch.from_numpy(org).to(dev)
    d = torch.from_numpy(dirv).to(dev)
    lht = torch.full((n,), -1, dtype=torch.int32, device=dev) \
        if lht is None else lht
    active = torch.ones(n, dtype=torch.bool, device=dev) \
        if active is None else active
    args = (tables.mbvh_rows, o, d, lht, active, tmbvh.tquant_scale(tables),
            int(tables.mbvh_depth), bool(tables.mbvh_instanced), 65536)
    k = mbvh_walk.closest_hit_cuda(*args)
    torch.cuda.synchronize()
    p = mbvh_walk.closest_hit_plain(*args)
    for key in ('triangle', 'material_code', 'incomplete'):
        bad = int((k[key] != p[key]).sum())
        check(bad == 0, '%s differs on %d of %d rays' % (key, bad, n))
    err = 0.0
    for key in ('distance', 'normal'):
        kb = k[key].view(torch.int32)
        pb = p[key].view(torch.int32)
        bad = int((kb != pb).sum())
        if bad:
            ulp = int((kb.long() - pb.long()).abs().max())
            check(False, '%s not bit-equal on %d values (max %d ulp)'
                  % (key, bad, ulp))
        fin = torch.isfinite(p[key])
        if fin.any():
            err = max(err, float((k[key][fin] - p[key][fin]).abs().max()))
    return int((k['triangle'] >= 0).sum()), err, args


def rays(n, seed):
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.zeros((n, 3), np.float32), d


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def compare_state(k, p, what):
    """Every field of two window states (or photon states) bit-equal;
    returns the max abs difference of the finite floats (0 then)."""
    err = 0.0
    for key in k:
        bad = int((bits(k[key]) != bits(p[key])).sum())
        check(bad == 0, '%s: %s differs on %d values' % (what, key, bad))
        if k[key].dtype == torch.float32:
            fin = torch.isfinite(p[key])
            if fin.any():
                err = max(err, float((k[key][fin] - p[key][fin])
                                     .abs().max()))
    return err


def clone_state(W):
    return {k: mbvh_walk.lane_minor(v.clone()) for k, v in W.items()}


def compare_window(tables, n, od_slots, seed, what):
    """Window kernel against plain from one seeded state: a service
    window, then a long window in which every walk drains."""
    depth, inst = int(tables.mbvh_depth), bool(tables.mbvh_instanced)
    args = mbvh_walk.root_seed_args(tables)
    k = mbvh_walk.random_window_state(
        tables.mbvh_rows, depth, inst, tmbvh.tquant_scale(tables), n,
        od_slots, seed)
    p = clone_state(k)
    err = 0.0
    for iters in (fused.SERVICE_EVERY, LONG_WINDOW):
        tmbvh.walk_window(tables, k, iters, od_slots, *args)
        torch.cuda.synchronize()
        tmbvh.walk_window(tables, p, iters, od_slots, *args, plain=True)
        err = max(err, compare_state(k, p, '%s, %d iterations'
                                     % (what, iters)))
    check(not k['act'].any() and bool((k['lvl'] < 0).all()),
          '%s: walks left after the long window' % what)
    parked = int(((k['pad'] & 1) != 0).sum())
    check(parked > 0, '%s: no walk parked' % what)
    print('window %s, od_slots %d: %d lanes, %d parked, bit-equal after '
          '%d and %d iterations' % (what, od_slots, n, parked,
                                    fused.SERVICE_EVERY, LONG_WINDOW))
    return err


def time_window(tables, n, od_slots, reps=5):
    """Device ms of one service window from a fresh seeded state: the
    kernel (mean of ``reps`` runs) and the plain version (one run), each
    after a warm-up run."""
    depth, inst = int(tables.mbvh_depth), bool(tables.mbvh_instanced)
    args = mbvh_walk.root_seed_args(tables)
    W0 = mbvh_walk.random_window_state(
        tables.mbvh_rows, depth, inst, tmbvh.tquant_scale(tables), n,
        od_slots, 17)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    out = []
    for plain, nrep in ((False, reps), (True, 1)):
        times = []
        for r in range(nrep + 1):
            W = clone_state(W0)
            torch.cuda.synchronize()
            start.record()
            tmbvh.walk_window(tables, W, fused.SERVICE_EVERY, od_slots,
                              *args, plain=plain)
            stop.record()
            torch.cuda.synchronize()
            if r:
                times.append(start.elapsed_time(stop))
        out.append(sum(times) / len(times))
    return out


def full_detector(dev):
    t0 = time.time()
    gg = gpu.GPUDetector.from_table_cache('full', device=dev)
    how = 'table cache'
    if gg is None:
        geo = host.demo.detector()
        geo.flatten()
        gg = gpu.GPUDetector(geo, dev)
        gg.save_table_cache('full')
        how = 'cold build (cache saved)'
    g = gg.geom
    print('full demo tables: %s in %.1f s; %d channels, %d triangles, '
          '%d MBVH rows of %d words, depth %d, instanced %s'
          % (how, time.time() - t0, gg.nchannels, g.triangles.shape[0],
             g.mbvh_rows.shape[0], g.mbvh_rows.shape[1], g.mbvh_depth,
             g.mbvh_instanced), flush=True)
    return gg


def main():
    # ---- 1. device ----------------------------------------------------
    check(torch.cuda.is_available(),
          'torch.cuda.is_available() is False: this needs an NVIDIA card')
    dev = torch.device('cuda:0')
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print('device: %s (torch %s, CUDA %s)'
          % (kind, torch.__version__, torch.version.cuda))
    print('nvidia-smi name, power.limit: %s' % card, flush=True)

    # ---- 2. build -----------------------------------------------------
    t0 = time.time()
    path, log = _build.build()
    _build.library()
    print('build: %s in %.1f s' % (os.path.relpath(path, ROOT),
                                   time.time() - t0))
    for line in log.splitlines():
        if 'registers' in line or 'spill' in line or 'stack frame' in line:
            print('  ptxas:', line.strip())
    sys.stdout.flush()

    # ---- 3. kernel against its plain version --------------------------
    err = 0.0
    sphere = pack_geometry(host.mesh_geometry(
        host.make.sphere(50.0, nsteps=24)), dev)
    hits, e, _ = compare_walk(sphere, *rays(256, 0), dev)
    check(hits == 256, 'flat sphere: %d of 256 rays hit' % hits)
    err = max(err, e)
    print('walk flat sphere (depth %d): 256 rays, %d hits, bit-equal'
          % (sphere.mbvh_depth, hits))
    for n in (341, 85, 129):
        hits, e, _ = compare_walk(sphere, *rays(n, 7), dev)
        err = max(err, e)
        print('walk flat sphere, ragged n=%d: %d hits, bit-equal' % (n, hits))

    sph16 = pack_geometry(host.mesh_geometry(
        host.make.sphere(50.0, nsteps=16)), dev)
    o, d = rays(128, 5)
    _, e, args = compare_walk(sph16, o, d, dev)
    first = mbvh_walk.closest_hit_plain(*args)['triangle']
    active = torch.arange(128, device=dev) % 2 == 0
    hits, e2, _ = compare_walk(sph16, o, d, dev, lht=first, active=active)
    err = max(err, e, e2)
    print('walk last_hit_triangle + active: %d hits of 64 active, '
          'bit-equal' % hits)

    tiny = host.demo.tiny()
    tiny.flatten()
    tiny_geom = pack_geometry(tiny, dev)
    hits, e, _ = compare_walk(tiny_geom, *rays(256, 3), dev)
    err = max(err, e)
    print('walk instanced demo.tiny (depth %d): 256 rays, %d hits, '
          'bit-equal' % (tiny_geom.mbvh_depth, hits))

    gg = full_detector(dev)
    nrays = NRAYS
    pos, dirs = benchmark._center_rays(nrays)
    hits, e, args = compare_walk(gg.geom, pos, dirs, dev)
    err = max(err, e)
    ms = cuda_ms(lambda: mbvh_walk.closest_hit_cuda(*args), 5)
    plain_ms = cuda_ms(lambda: mbvh_walk.closest_hit_plain(*args), 1)
    print('walk full demo: %d center rays, %d hits, bit-equal; kernel '
          '%.3f ms, plain %.3f ms (%s)' % (nrays, hits, ms, plain_ms, card),
          flush=True)
    check(hits > 0.9 * nrays, 'full demo: only %d of %d rays hit'
          % (hits, nrays))

    # ---- 4. the on-deck window kernel against its plain version -------
    werr = {1: 0.0, 2: 0.0}
    for what, tables, n, od_slots in (
            ('flat sphere', sphere, 256, 1), ('flat sphere', sphere, 256, 2),
            ('flat sphere, ragged', sphere, 129, 2),
            ('demo.tiny', tiny_geom, 256, 1), ('demo.tiny', tiny_geom, 256, 2),
            ('demo.tiny, ragged', tiny_geom, 129, 1),
            ('full demo', gg.geom, fused.DEFAULT_WIDTH, 1),
            ('full demo', gg.geom, fused.DEFAULT_WIDTH, 2)):
        werr[od_slots] = max(werr[od_slots], compare_window(
            tables, n, od_slots, n + od_slots, what))
    wms = {}
    for od_slots in (1, 2):
        wms[od_slots] = time_window(gg.geom, fused.DEFAULT_WIDTH, od_slots)
        print('window full demo, od_slots %d, %d lanes, %d iterations: '
              'kernel %.3f ms, plain %.3f ms (%s)'
              % (od_slots, fused.DEFAULT_WIDTH, fused.SERVICE_EVERY,
                 wms[od_slots][0], wms[od_slots][1], card), flush=True)

    # ---- 5. the whole on-deck driver, kernel against plain walker -------
    np.random.seed(4)
    ph = host.photon_bomb(NDRIVER, G.WAVELENGTH, G.BOMB_POS).photons_beg
    for od_slots in (1, 2):
        outs = []
        for plain in (False, True):
            gen = torch.Generator(device=dev)
            gen.manual_seed(11)
            state = gpu.GPUPhotons(ph, dev).state
            t0 = time.time()
            out, stats = fused.propagate_fused(
                state, tiny_geom, fused.uniform_draws(gen), max_steps=100,
                width=NDRIVER // 4, od_slots=od_slots, plain_walker=plain)
            torch.cuda.synchronize()
            outs.append((out, stats, time.time() - t0))
        (k, ks, kt), (p, ps, pt) = outs
        compare_state(k, p, 'on-deck driver, od_slots %d' % od_slots)
        check(torch.equal(ks, ps), 'driver stats differ: %s vs %s'
              % (ks.tolist(), ps.tolist()))
        print('on-deck driver, demo.tiny, %d photons, od_slots %d: final '
              'photons bit-equal, kernel against plain walker; stats %s; '
              'wall %.3f s vs %.3f s' % (NDRIVER, od_slots, ks.tolist(),
                                          kt, pt), flush=True)
    for od_slots in (1, 2):
        bad = referee.terminal_passthrough(gg.geom, n=65536, width=16384,
                                           od_slots=od_slots)
        check(not bad, 'referee check 1 (od_slots %d): %s not bit-exact'
              % (od_slots, bad))
    print('referee check 1, full demo, 65,536 adversarial terminal '
          'photons, od_slots 1 and 2: bit-exact', flush=True)

    # ---- 6. the main path --------------------------------------------
    # each path runs with the launch counts set to 0 just before it
    counters = [mbvh_walk.closest_hit_launches,
                *mbvh_walk.walk_window_launches.values()]

    def reset():
        for c in counters:
            c.reset()

    reset()
    ray_rates = benchmark.intersect(gg, number=3, nphotons=nrays)
    ch_launches = mbvh_walk.closest_hit_launches.launches
    check(ch_launches > 0, 'intersect_mesh never launched the walker kernel')
    print('ray intersections/s, full demo, %d center rays: %s; mean %.0f '
          '(%s)' % (nrays, ['%.0f' % r for r in ray_rates],
                    ray_rates.mean(), card))
    nphotons = NPHOTONS
    w_launches = {}
    for label, number, kw in (('on-deck od_slots=1', 3, dict(od_slots=1)),
                              ('on-deck od_slots=2', 1, dict(od_slots=2)),
                              ('step loop', 3, dict(driver='steps'))):
        reset()
        rates, gp = benchmark.propagate(gg, number=number,
                                        nphotons=nphotons, max_steps=100,
                                        **kw)
        flags = gp.state['flags']
        terminal = float(((flags & TERMINAL) != 0).float().mean())
        if 'od_slots' in kw:
            od_slots = kw['od_slots']
            w_launches[od_slots] = \
                mbvh_walk.walk_window_launches[od_slots].launches
            check(w_launches[od_slots] > 0, 'the %s driver never launched '
                  'the window kernel' % label)
            st = gp.last_stats
            w = min(fused.DEFAULT_WIDTH, nphotons)
            how = ('%d service passes, %d photon-steps, %d lane-iterations'
                   ' (holding share %.4f, photon-steps per lane-iteration '
                   '%.4f)' % (st[0], st[1], st[2],
                              st[2] / (st[0] * w * fused.SERVICE_EVERY),
                              st[1] / st[2]))
        else:
            ch_launches += mbvh_walk.closest_hit_launches.launches
            check(mbvh_walk.closest_hit_launches.launches > 0,
                  'the step loop never launched the walker kernel')
            how = '%d steps' % gp.last_steps
        print('photons propagated/s, full demo, %d isotropic 400 nm '
              'photons, max_steps=100, %s: %s; mean %.0f (%s); %s; '
              'terminal %.5f' % (nphotons, label,
                                 ['%.0f' % r for r in rates], rates.mean(),
                                 card, how, terminal), flush=True)
        check(terminal >= 0.99, '%s: only %.4f of photons ended terminal'
              % (label, terminal))

    # ---- 7. full-demo physics against its golden ----------------------
    golden = np.load(os.path.join(GOLDEN_DIR, 'demo_full_pdf.npz'))
    seed = int(golden['seed']) + 31
    nev = int(golden['nevents'])
    t_hist = np.zeros(len(G.FULL_TIME_BINS) - 1)
    det = 0
    for i in range(nev):
        np.random.seed(seed * 1000 + i)
        ph = host.photon_bomb(G.FULL_NPHOTONS, G.WAVELENGTH,
                              (0.0, 0.0, 0.0)).photons_beg
        p = gpu.GPUPhotons(ph, dev)
        p.propagate(gg, gpu.get_rng_states(seed=seed * 77 + i, device=dev))
        detected = (p.state['flags'] & i32(host.event.SURFACE_DETECT)) != 0
        det += int(detected.sum())
        t_hist += np.histogram(p.state['t'][detected].cpu().numpy(),
                               G.FULL_TIME_BINS)[0]
    det_frac = det / float(nev * G.FULL_NPHOTONS)
    c2 = chi2_ndf(golden['t_hist'], t_hist)
    print('full-demo golden (on-deck driver): det_frac %.5f (golden %.5f), '
          't_hist chi2/ndf %.3f' % (det_frac, float(golden['det_frac']), c2),
          flush=True)
    check(abs(det_frac - float(golden['det_frac'])) < 0.004,
          'full-demo detection fraction')
    check(c2 < 2.0, 'full-demo hit-time chi2/ndf %.3f' % c2)

    # ---- 8. Simulation + DAQ on demo.tiny, both drivers ---------------
    # The demo.tiny golden is off from the JAX package itself: one
    # 8-event sample per seed against it gives hit-time chi2/ndf above 2
    # for 3 of 11 seeds on the CPU (PERF.md, Findings), so a single seed
    # passed or failed this phase by luck.  The golden is therefore held
    # only where it is sound (detection fraction and peak bin), and the
    # hit-time shape is gated between the two drivers' pooled samples
    # (4 x NEVENTS events each, independent seeds) at equal exposure;
    # chi2 against the golden is printed per 8-event block, ungated.
    golden = np.load(os.path.join(GOLDEN_DIR, 'demo_tiny_pdf.npz'))
    pooled = {}
    for k, driver in enumerate(('fused', 'steps')):
        sim = Simulation(host.demo.tiny(), seed=G.GOLDEN_SEED + k,
                         device=dev, driver=driver)
        t_hist = np.zeros((4, len(G.TIME_BINS) - 1))
        fracs = []
        for e in range(4 * G.NEVENTS):
            ev = next(sim.simulate(
                [host.photon_bomb(G.NPHOTONS, G.WAVELENGTH, G.BOMB_POS)],
                run_daq=True))
            hit = np.asarray(ev.channels.hit, bool)
            t_hist[e // G.NEVENTS] += np.histogram(ev.channels.t[hit],
                                                   G.TIME_BINS)[0]
            fracs.append(len(ev.flat_hits) / float(G.NPHOTONS))
        det_frac = float(np.mean(fracs))
        pooled[driver] = t_hist.sum(axis=0)
        peak = abs(int(np.argmax(golden['t_hist']))
                   - int(np.argmax(pooled[driver])))
        blocks = [chi2_ndf(golden['t_hist'], h) for h in t_hist]
        print('demo.tiny Simulation+DAQ, %s driver, %d events: det_frac '
              '%.5f (golden %.5f), peak offset %d bins; t chi2/ndf against '
              'the golden per %d events (not gated): %s'
              % (driver, 4 * G.NEVENTS, det_frac,
                 float(golden['det_frac']), peak, G.NEVENTS,
                 ['%.3f' % c for c in blocks]), flush=True)
        check(abs(det_frac - float(golden['det_frac'])) < 0.005,
              'demo.tiny detection fraction (%s driver)' % driver)
        check(peak <= 1, 'demo.tiny hit-time peak moved %d bins (%s '
              'driver)' % (peak, driver))
    ct = chi2_ndf(pooled['fused'], pooled['steps'])
    print('demo.tiny hit times, on-deck driver against step loop, pooled: '
          'chi2/ndf %.3f' % ct, flush=True)
    check(ct < 2.0, 'demo.tiny hit-time chi2/ndf between the drivers %.3f'
          % ct)

    print('nvidia-smi name, power.limit: %s' % card)
    entries = [{
        'name': 'mbvh_closest_hit', 'route': 'cuda',
        'source': 'chroma_tpu_torch/csrc/mbvh_walk.cu',
        'replaces': 'chroma_tpu/ops/mbvh_pallas.py:636',
        'launches': ch_launches, 'max_abs_err': err, 'ms': ms,
        'plain_ms': plain_ms}]
    for od_slots in (1, 2):
        entries.append({
            'name': 'mbvh_walk_window_od%d' % od_slots, 'route': 'cuda',
            'source': 'chroma_tpu_torch/csrc/mbvh_walk_window.cu',
            'replaces': 'chroma_tpu/ops/mbvh_pallas.py:636',
            'launches': w_launches[od_slots],
            'max_abs_err': werr[od_slots], 'ms': wms[od_slots][0],
            'plain_ms': wms[od_slots][1]})
    print(json.dumps({'kernels': entries}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()

"""Run the PyTorch/CUDA port's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles chroma_tpu_torch/csrc/*.cu with nvcc;
  3. the walker kernel against its plain PyTorch version on the card
     (flat sphere, instanced demo.tiny, last-hit/active, ragged widths,
     500,000 center rays in the full demo): equal triangles and material
     codes, bit-equal distances and normals, and both times;
  4. the main path: full demo tables from the table cache (built and
     saved on a miss), 500,000 center rays through ``intersect_mesh``
     and 1,048,576 photons through ``GPUPhotons.propagate`` (one warm-up,
     three timed runs each); >= 99% of photons must end terminal;
  5. full-demo physics against tests/golden/demo_full_pdf.npz;
  6. ``Simulation.simulate(run_daq=True)`` on demo.tiny against
     tests/golden/demo_tiny_pdf.npz.
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
from chroma_tpu_torch.ops import mbvh as tmbvh, mbvh_walk  # noqa: E402
from chroma_tpu_torch.ops.geometry_pack import pack_geometry  # noqa: E402
from chroma_tpu_torch.ops.propagate import TERMINAL, i32  # noqa: E402
from chroma_tpu_torch.sim import Simulation  # noqa: E402
from tools import golden_config as G  # noqa: E402

GOLDEN_DIR = os.path.join(ROOT, 'tests', 'golden')
NRAYS = 500000          # benchmark.intersect's batch
NPHOTONS = 1 << 20      # bench.py's batch


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

    # ---- 4. the main path --------------------------------------------
    mbvh_walk.closest_hit_launches.reset()
    ray_rates = benchmark.intersect(gg, number=3, nphotons=nrays)
    print('ray intersections/s, full demo, %d center rays: %s; mean %.0f '
          '(%s)' % (nrays, ['%.0f' % r for r in ray_rates],
                    ray_rates.mean(), card))
    nphotons = NPHOTONS
    rates, gp = benchmark.propagate(gg, number=3, nphotons=nphotons,
                                    max_steps=100)
    flags = gp.state['flags']
    terminal = float(((flags & TERMINAL) != 0).float().mean())
    print('photons propagated/s, full demo, %d isotropic 400 nm photons, '
          'max_steps=100: %s; mean %.0f (%s); %d steps; terminal %.5f'
          % (nphotons, ['%.0f' % r for r in rates], rates.mean(), card,
             gp.last_steps, terminal), flush=True)
    check(terminal >= 0.99, 'only %.4f of photons ended terminal'
          % terminal)

    # ---- 5. full-demo physics against its golden ----------------------
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
    print('full-demo golden: det_frac %.5f (golden %.5f), t_hist '
          'chi2/ndf %.3f' % (det_frac, float(golden['det_frac']), c2),
          flush=True)
    check(abs(det_frac - float(golden['det_frac'])) < 0.004,
          'full-demo detection fraction')
    check(c2 < 2.0, 'full-demo hit-time chi2/ndf %.3f' % c2)

    # ---- 6. Simulation + DAQ against the demo.tiny golden -------------
    # make_golden.py's protocol and seed; the port's torch.Generator does
    # not reproduce the golden's threefry draws, so the sample is fresh
    golden = np.load(os.path.join(GOLDEN_DIR, 'demo_tiny_pdf.npz'))
    sim = Simulation(host.demo.tiny(), seed=G.GOLDEN_SEED, device=dev)
    t_hist = np.zeros(len(G.TIME_BINS) - 1)
    q_hist = np.zeros(len(G.CHARGE_BINS) - 1)
    fracs = []
    for _ in range(G.NEVENTS):
        ev = next(sim.simulate(
            [host.photon_bomb(G.NPHOTONS, G.WAVELENGTH, G.BOMB_POS)],
            run_daq=True))
        hit = np.asarray(ev.channels.hit, bool)
        t_hist += np.histogram(ev.channels.t[hit], G.TIME_BINS)[0]
        q_hist += np.histogram(ev.channels.q[hit], G.CHARGE_BINS)[0]
        fracs.append(len(ev.flat_hits) / float(G.NPHOTONS))
    det_frac = float(np.mean(fracs))
    ct, cq = chi2_ndf(golden['t_hist'], t_hist), \
        chi2_ndf(golden['q_hist'], q_hist)
    peak = abs(int(np.argmax(golden['t_hist'])) - int(np.argmax(t_hist)))
    print('demo.tiny Simulation+DAQ golden: det_frac %.5f (golden %.5f), '
          't chi2/ndf %.3f, q chi2/ndf %.3f, peak offset %d bins'
          % (det_frac, float(golden['det_frac']), ct, cq, peak), flush=True)
    check(ct < 2.0 and cq < 2.0, 'demo.tiny hit-time/charge chi2/ndf')
    check(abs(det_frac - float(golden['det_frac'])) < 0.005,
          'demo.tiny detection fraction')
    check(peak <= 1, 'demo.tiny hit-time peak moved %d bins' % peak)

    launches = mbvh_walk.closest_hit_launches.launches
    check(launches > 0, 'the main path never launched the walker kernel')
    print('nvidia-smi name, power.limit: %s' % card)
    print(json.dumps({'kernels': [{
        'name': 'mbvh_closest_hit', 'route': 'cuda',
        'source': 'chroma_tpu_torch/csrc/mbvh_walk.cu',
        'replaces': 'chroma_tpu/ops/mbvh_pallas.py:636',
        'launches': launches, 'max_abs_err': err, 'ms': ms,
        'plain_ms': plain_ms}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()

"""Run the PyTorch/CUDA port's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles chroma_tpu_torch/csrc/*.cu with nvcc, one process
     per source, all started together; prints each kernel's ptxas
     registers, stack frame and spills;
  3. the closest-hit walker kernel (one warp per ray) against its plain
     PyTorch version on the card (flat sphere, instanced demo.tiny,
     last-hit/active, ragged widths at the warp and block edges, the tie
     scene flat and instanced with axis-parallel rays, 500,000 center
     rays in the full demo and, flat, in demo.tiny): equal triangles and
     material codes, bit-equal distances and normals; both times, and
     the kernel's bound counted from this run's walks;
  4. the on-deck window kernel (K3, K4) against its plain version: flat
     sphere, demo.tiny, the tie scene and the full demo, od_slots 1 and
     2, ragged widths; a service window and a long window in which every
     walk drains; every state field bit-equal; both times and the bound
     at full-demo width;
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

A kernel's bound is the least time the card could take for its work:
the larger of the bytes it must move (each input read once, each output
written once; of the rows table, the rows this run's walks read; the
16-bit pending codes at 2 bytes) over 3.35 TB/s and the float
operations this run's walks needed (counted op by op from the code, see
FLOPS_*) over 67 TFLOP/s fp32, the
published peaks of an H100 SXM at 700 W.  No PyTorch call computes a
BVH walk, so no kernel has a library time.
"""
import json
import os
import re
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
# ray counts at the edges of a warp (one warp walks one ray) and of a
# block of 8 rays; 85, 341 and 1001 are not multiples of the block
GROUP_EDGES = (1, 31, 33, 85, 129, 341, 1001)

PEAK_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM, HBM3
# Float operations, counted op by op from
# chroma_tpu_torch/csrc/mbvh_walk_core.cuh: one per float add, sub, mul,
# div, min, max, compare or floor; conversions, selects, sign and
# absolute-value modifiers and integer work are not counted.
# One child box of an internal row (`slab`, `slab_axis`, the push in
# `process_row`): dequantize lo and hi on 3 axes, 12 (a mul and an add
# each); t0 and t1 on 3 axes, 12; isfinite(inv), 3; min and max of t0,
# t1, 6; fold the axes into tmin, tmax, 4; clamp tmin at 0, 1;
# tmin <= tmax and tmin <= min_dist, 2; floor(tmin * sq), 2; the clip of
# the code to [0, 65534], 2.
FLOPS_SLAB = 44
# A root child in `seed_root`: from the root row (the closest-hit
# kernel), the same but the min_dist test; from the dequantized
# `root_lohi` (the window kernel's restarts), also without the 12 of
# dequantization.
FLOPS_SEED_ROW = 43
FLOPS_SEED_LOHI = 31
# One triangle of a cluster row (Moller-Trumbore in `process_row`):
# dequantize 9 coordinates, 18; e1, e2, s, 9; h = d x e2, 9; a = e1.h,
# 5; |a| > eps, 1; f = 1/a, 1; u = f (s.h), 6; q = s x e1, 9;
# v = f (d.q), 6; t = f (e2.q), 6; u + v and the 5 tests of u, v,
# u + v and t, 6; t < the thread's best, 1.
FLOPS_MT = 77
# Once a cluster row: the winner's normal e1 x e2, 9; the improvement
# test, 1; + 0.0 on three components, 3.  (The rotation of an improved
# instanced normal, 15, is not tallied.)
FLOPS_CLUSTER_ROW = 13
# Once an entry row: org - translation, 3; rotate org and dir, 30;
# 1/dir, 3; -org/dir, 3.
FLOPS_ENTRY = 39
# Once a processed row (the pop): floor(min_dist * sq) + 1 and its
# clip, 5.
FLOPS_POP = 5
# Once a (re)started ray (`set_ray`): 1/dir and -org/dir, 6.
FLOPS_RAY = 6
ROW_BYTES = mbvh_walk.ROW_WIDTH * 4
RAY_IN_BYTES = 12 + 12 + 4 + 1      # org, dir, last-hit triangle, active
RAY_OUT_BYTES = 4 + 4 + 12 + 4 + 1  # triangle, distance, normal, mat, inc


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


def bound(flops, nbytes):
    """(bound ms, what binds) for ``flops`` float operations moving
    ``nbytes`` bytes."""
    t_ops = flops / PEAK_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def work_flops(work, rcount, flops_seed_child):
    """Float operations of the walks tallied in ``work``, with root
    seeds of ``rcount`` children at ``flops_seed_child`` each."""
    return (work.get('internal_slots', 0) * FLOPS_SLAB
            + work.get('cluster_slots', 0) * FLOPS_MT
            + work.get('cluster_rows', 0) * FLOPS_CLUSTER_ROW
            + work.get('entry_rows', 0) * FLOPS_ENTRY
            + (work.get('internal_rows', 0) + work.get('cluster_rows', 0))
            * FLOPS_POP
            + work.get('seeds', 0) * (FLOPS_RAY + rcount * flops_seed_child))


def closest_hit_bound(args):
    """Work, bytes and bound of one closest-hit launch on ``args``,
    counted from the plain version's walks on the same inputs."""
    rows, active, depth = args[0], args[4], args[6]
    work = {}
    mbvh_walk.closest_hit_plain(*args, work=work)
    rcount = 0
    if depth >= 2:
        rcount = (int(rows[0, mbvh_walk.HDR_KIND]) >> 8) & 0xFFFFFF
        work['seeds'] = int(active.sum())
        work['visited'][0] = True
    n = active.shape[0]
    flops = work_flops(work, rcount, FLOPS_SEED_ROW)
    nbytes = n * (RAY_IN_BYTES + RAY_OUT_BYTES) \
        + int(work['visited'].sum()) * ROW_BYTES
    return dict(work, flops=flops, bytes=nbytes,
                rows_read=int(work['visited'].sum()),
                lane_iterations=work['internal_rows'] + work['cluster_rows'],
                bound=bound(flops, nbytes))


def report_bound(what, b, ms):
    print('%s: %d lane-iterations (%d internal, %d cluster rows), %d '
          'rows read; %.3f GFLOP, %.1f MB; bound %.4f ms (%s); kernel '
          '%.3f ms = %.1f%% of the bound'
          % (what, b['lane_iterations'], b['internal_rows'],
             b['cluster_rows'], b['rows_read'], b['flops'] / 1e9,
             b['bytes'] / 1e6, b['bound'][0], b['bound'][1], ms,
             100.0 * b['bound'][0] / ms), flush=True)


def ptxas_summary(log):
    """{kernel<template args>: 'registers, stack, spills'} from
    nvcc -Xptxas=-v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r'(closest_hit_kernel|walk_window_kernel)I'
                      r'((?:L[a-z]+\d+E)+)E', line)
        if 'Compiling entry function' in line and m:
            name = '%s<%s>' % (m.group(1), ', '.join(
                re.findall(r'L[a-z]+(\d+)E', m.group(2))))
            out[name] = ''
        elif name and ('stack frame' in line or 'registers' in line):
            out[name] = (out[name] + '; ' if out[name] else '') \
                + line.split(':', 1)[-1].strip()
    return out


def compare_walk(tables, org, dirv, dev, lht=None, active=None):
    """Kernel vs plain version on the same card tensors.  Returns
    (number of hits, max abs difference of distance and normal, the
    kernel's arguments)."""
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
    return mbvh_walk.window_layout({k: v.clone() for k, v in W.items()})


def axis_state(tables, od_slots, dev):
    """Six lanes walking along +-x, +-y, +-z (1/dir infinite on two
    axes), with on-deck rays along the same axes reversed and rotated."""
    o, d = (torch.from_numpy(a).to(dev) for a in host.axis_rays())
    every = torch.ones(6, dtype=torch.bool, device=dev)
    return mbvh_walk.window_state(
        tables.mbvh_rows, int(tables.mbvh_depth),
        bool(tables.mbvh_instanced), tmbvh.tquant_scale(tables), o, d,
        every, [(o, -d, every), (o, d.roll(2, 0), every)][:od_slots])


def compare_window(tables, n, od_slots, seed, what, state=None):
    """Window kernel against plain from one seeded state (``state``, or
    a random one of ``n`` lanes): a service window, then a long window
    in which every walk drains."""
    depth, inst = int(tables.mbvh_depth), bool(tables.mbvh_instanced)
    args = mbvh_walk.root_seed_args(tables)
    k = state if state is not None else mbvh_walk.random_window_state(
        tables.mbvh_rows, depth, inst, tmbvh.tquant_scale(tables), n,
        od_slots, seed)
    p = clone_state(k)
    err = 0.0
    for iters in (fused.SERVICE_EVERY, LONG_WINDOW):
        mbvh_walk.walk_window_cuda(
            tables.mbvh_rows, k, iters, depth, inst,
            tmbvh.tquant_scale(tables), od_slots, *args)
        torch.cuda.synchronize()
        tmbvh.walk_window(tables, p, iters, od_slots, *args, plain=True)
        err = max(err, compare_state(k, p, '%s, %d iterations'
                                     % (what, iters)))
    check(not k['act'].any() and bool((k['lvl'] < 0).all()),
          '%s: walks left after the long window' % what)
    parked = int(((k['pad'] & 1) != 0).sum())
    check(parked > 0 or n < 32, '%s: no walk parked' % what)
    print('window %s, od_slots %d: %d lanes, %d parked, bit-equal after '
          '%d and %d iterations'
          % (what, od_slots, n, parked, fused.SERVICE_EVERY, LONG_WINDOW))
    return err


def state_bytes(W):
    """Bytes of a window state, the pending codes at 2 bytes: they are
    16-bit codes (the TPU kernel keeps them as int16), whatever the
    port's storage holds them in."""
    return sum(v.numel() * (2 if k == 'tcodes' else v.element_size())
               for k, v in W.items())


def window_bound(tables, W0, od_slots, args):
    """Work, bytes and bound of one service window from state ``W0``,
    counted from the plain version's walks on a copy: the state read
    once and, for the lanes that change, written once, the rows read,
    ``root_lohi``."""
    W = clone_state(W0)
    work = {}
    mbvh_walk.walk_window_plain(
        tables.mbvh_rows, W, fused.SERVICE_EVERY, int(tables.mbvh_depth),
        bool(tables.mbvh_instanced), tmbvh.tquant_scale(tables), od_slots,
        *args, work=work)
    n = W0['act'].shape[0]
    sbytes = state_bytes(W0)
    changed = int(work['changed'].sum()) if 'changed' in work else 0
    rows_read = int(work['visited'].sum()) if 'visited' in work else 0
    flops = work_flops(work, args[1], FLOPS_SEED_LOHI)
    nbytes = sbytes + sbytes * changed // n \
        + rows_read * ROW_BYTES + args[2].numel() * 4
    return dict(work, flops=flops, bytes=nbytes, rows_read=rows_read,
                internal_rows=work.get('internal_rows', 0),
                cluster_rows=work.get('cluster_rows', 0),
                lane_iterations=work.get('internal_rows', 0)
                + work.get('cluster_rows', 0),
                bound=bound(flops, nbytes))


def time_window(tables, n, od_slots, reps=5):
    """Device ms of one service window from a fresh seeded state: the
    kernel (mean of ``reps`` runs) and the plain version (one run), each
    after a warm-up run; and the window's bound."""
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
    return out + [window_bound(tables, W0, od_slots, args)]


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
    ptxas = ptxas_summary(log)
    check(len(ptxas) == 6, 'ptxas reported %d of 6 kernel instantiations'
          % len(ptxas))
    for name, what in sorted(ptxas.items()):
        print('  ptxas: %s: %s' % (name, what))
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
    for name, tables in (('flat sphere', sphere), ('demo.tiny', tiny_geom)):
        for n in GROUP_EDGES:
            _, e, _ = compare_walk(tables, *rays(n, 100 + n), dev)
            err = max(err, e)
        print('walk %s, ragged n=%s: bit-equal'
              % (name, '/'.join(map(str, GROUP_EDGES))))

    ties = {'flat': pack_geometry(host.tie_geometry(), dev),
            'instanced': pack_geometry(host.tie_geometry(), dev,
                                       instancing=True)}
    for name, tables in ties.items():
        check(tables.mbvh_instanced == (name == 'instanced'),
              'tie scene %s packed instanced=%s'
              % (name, tables.mbvh_instanced))
        o, d = rays(300, 8)
        hits, e, args = compare_walk(tables, o, d, dev)
        first = mbvh_walk.closest_hit_plain(*args)['triangle']
        _, e2, _ = compare_walk(tables, o, d, dev, lht=first)
        _, e3, _ = compare_walk(tables, *host.axis_rays(), dev)
        err = max(err, e, e2, e3)
        check(hits == 300, 'tie scene: %d of 300 rays hit' % hits)
        print('walk tie scene, %s (twin triangles%s): 300 rays, their '
              'last-hit twins skipped, 6 axis-parallel rays: bit-equal'
              % (name, ', two equal entry boxes' if name == 'instanced'
                 else ''))

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
    ch_bound = closest_hit_bound(args)
    report_bound('closest hit K2, full demo, %d center rays' % nrays,
                 ch_bound, ms)

    # K1 at a main-path-sized shape: demo.tiny packed flat
    tiny_flat = pack_geometry(tiny, dev, instancing=False)
    hits, e, args1 = compare_walk(tiny_flat, pos, dirs, dev)
    err = max(err, e)
    ms1 = cuda_ms(lambda: mbvh_walk.closest_hit_cuda(*args1), 5)
    plain_ms1 = cuda_ms(lambda: mbvh_walk.closest_hit_plain(*args1), 1)
    print('walk demo.tiny flat (K1, depth %d, %d rows): %d center rays, '
          '%d hits, bit-equal; kernel %.3f ms, plain %.3f ms (%s)'
          % (tiny_flat.mbvh_depth, tiny_flat.mbvh_rows.shape[0], nrays,
             hits, ms1, plain_ms1, card), flush=True)
    report_bound('closest hit K1, demo.tiny flat, %d center rays' % nrays,
                 closest_hit_bound(args1), ms1)

    # ---- 4. the on-deck window kernel against its plain version -------
    werr = {1: 0.0, 2: 0.0}
    cases = [('flat sphere', sphere, 256, 1), ('flat sphere', sphere, 256, 2),
             ('demo.tiny', tiny_geom, 256, 1), ('demo.tiny', tiny_geom, 256, 2),
             ('tie scene, flat', ties['flat'], 256, 1),
             ('tie scene, instanced', ties['instanced'], 256, 2)]
    cases += [('%s, ragged' % name, tables, n, od_slots)
              for name, tables in (('flat sphere', sphere),
                                   ('demo.tiny', tiny_geom))
              for n in (1, 31, 33, 129, 1001) for od_slots in (1, 2)]
    cases += [('full demo', gg.geom, fused.DEFAULT_WIDTH, 1),
              ('full demo', gg.geom, fused.DEFAULT_WIDTH, 2)]
    for what, tables, n, od_slots in cases:
        werr[od_slots] = max(werr[od_slots], compare_window(
            tables, n, od_slots, n + od_slots, what))
    for what, tables in (('tie scene, flat', ties['flat']),
                         ('tie scene, instanced', ties['instanced'])):
        for od_slots in (1, 2):
            werr[od_slots] = max(werr[od_slots], compare_window(
                tables, 6, od_slots, 0, what + ', axis-parallel rays',
                state=axis_state(tables, od_slots, dev)))
    wms = {}
    for od_slots in (1, 2):
        wms[od_slots] = time_window(gg.geom, fused.DEFAULT_WIDTH, od_slots)
        print('window full demo, od_slots %d, %d lanes, %d iterations: '
              'kernel %.3f ms, plain %.3f ms (%s)'
              % (od_slots, fused.DEFAULT_WIDTH, fused.SERVICE_EVERY,
                 wms[od_slots][0], wms[od_slots][1], card), flush=True)
        report_bound('window K%d, full demo, %d lanes x %d iterations'
                     % (2 + od_slots, fused.DEFAULT_WIDTH,
                        fused.SERVICE_EVERY), wms[od_slots][2],
                     wms[od_slots][0])

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
          '(%s); %d kernel launches in %d intersect calls'
          % (nrays, ['%.0f' % r for r in ray_rates], ray_rates.mean(), card,
             ch_launches, len(ray_rates) + 1))
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
                   '%.4f); %d window launches in %d propagations'
                   % (st[0], st[1], st[2],
                      st[2] / (st[0] * w * fused.SERVICE_EVERY),
                      st[1] / st[2], w_launches[od_slots], number + 1))
        else:
            ch_launches += mbvh_walk.closest_hit_launches.launches
            check(mbvh_walk.closest_hit_launches.launches > 0,
                  'the step loop never launched the walker kernel')
            how = '%d steps; %d closest-hit launches in %d propagations' \
                % (gp.last_steps, mbvh_walk.closest_hit_launches.launches,
                   number + 1)
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
    def timing(ms_, plain, b):
        return {'ms': ms_, 'plain_ms': plain, 'bound_ms': b['bound'][0],
                'bound_by': b['bound'][1], 'library_ms': None,
                'share': b['bound'][0] / ms_}

    entries = [dict({
        'name': 'mbvh_closest_hit', 'route': 'cuda',
        'source': 'chroma_tpu_torch/csrc/mbvh_walk.cu',
        'replaces': 'chroma_tpu/ops/mbvh_pallas.py:636',
        'launches': ch_launches, 'max_abs_err': err},
        **timing(ms, plain_ms, ch_bound))]
    for od_slots in (1, 2):
        entries.append(dict({
            'name': 'mbvh_walk_window_od%d' % od_slots, 'route': 'cuda',
            'source': 'chroma_tpu_torch/csrc/mbvh_walk_window.cu',
            'replaces': 'chroma_tpu/ops/mbvh_pallas.py:636',
            'launches': w_launches[od_slots],
            'max_abs_err': werr[od_slots]}, **timing(*wms[od_slots])))
    print(json.dumps({'kernels': entries}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()

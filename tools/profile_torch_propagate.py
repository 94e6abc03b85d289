"""Where the time of one chroma_tpu_torch propagation goes, on one card.

    python tools/profile_torch_propagate.py [--nphotons N] [--detector full]
        [--driver fused|steps] [--od-slots 1|2] [--width W]
        [--service-every K] [--sweep] [--eval-pdf] [--render]

Loads the packed tables from the table cache ('full' is filled by
``chip_smoke.py``, under .cache/chroma_tpu in the checkout unless
CHROMA_TPU_CACHE says otherwise), propagates one isotropic 400 nm batch
from the centre once to warm up, then once under ``torch.profiler`` and
prints: wall time, the driver's step count or stats, the device time of
the walker kernel against all device time, the device's idle share over
the run, the ten largest device kernels, and the program's own spans
(``chroma_tpu_torch.tracing``) with their count, total and self host ms:
``step.live`` (the host waiting for the device) against ``step.draw``,
``.gather``, ``.walk``, ``.physics``, ``.scatter`` (issuing a step) on
the step loop, ``pass.wait`` against ``pass.walk`` and ``pass.service``
on the lane-pool driver.  The profiler slows the host, so these host
times are high against an unprofiled run.

``--eval-pdf`` profiles one ``Simulation.eval_pdf`` instead (the
likelihood path: weighted, scatter-stratified propagation, DAQ at ndaq
32, variable-bin PDF) at ``benchmark.pdf_eval``'s size: 20,000 photons,
nreps 2, after one warm-up evaluation.

``--render`` profiles one frame of ``camera.Camera`` instead (800x600,
alpha_depth 10, from the default viewpoint, after one warm-up frame): the
closest-hit kernel's share of the device's busy time against shading and
compositing.

``--sweep`` instead times the on-deck driver (``benchmark.propagate``,
one warm-up and two timed runs each) over lane widths and service
windows and prints photons/s with the driver's stats for each.  Needs a
CUDA card.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault('CHROMA_TPU_CACHE',
                      os.path.join(ROOT, '.cache', 'chroma_tpu'))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chroma_tpu_torch import benchmark, gpu, tracing  # noqa: E402
from chroma_tpu_torch.ops import fused  # noqa: E402

SWEEP_WIDTHS = (32768, 65536, 131072)
SWEEP_SERVICE_EVERY = (8, 17, 32)
_WALKERS = ('closest_hit_kernel', 'walk_window_kernel',
            'walk_window_k5_kernel')


def _driver_kw(args):
    if args.driver == 'steps':
        return dict(driver='steps')
    return dict(od_slots=args.od_slots, width=args.width,
                service_every=args.service_every)


def _stats_line(gp, nphotons, width, service_every):
    if gp.last_stats is None:
        return '%d steps' % gp.last_steps
    st = gp.last_stats
    w = min(width or fused.DEFAULT_WIDTH, nphotons)
    return ('%d service passes, %d photon-steps, %d lane-iterations, '
            'holding share %.4f' % (st[0], st[1], st[2],
                                    st[2] / (st[0] * w * service_every)))


def sweep(gg, args, card):
    for width in SWEEP_WIDTHS:
        for se in SWEEP_SERVICE_EVERY:
            rates, gp = benchmark.propagate(
                gg, number=2, nphotons=args.nphotons, max_steps=100,
                od_slots=args.od_slots, width=width, service_every=se)
            print('sweep width %d service_every %d od_slots %d: photons/s '
                  '%s, mean %.0f; %s (%s)'
                  % (width, se, args.od_slots,
                     ['%.0f' % r for r in rates], rates.mean(),
                     _stats_line(gp, args.nphotons, width, se), card),
                  flush=True)


def report(prof, wall):
    """Device busy time, idle share, the walker kernels' share and the
    ten largest device kernels of a profiled region of ``wall`` s (not
    the device-side copies of the program's span ranges)."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith('chroma_tpu_torch.')]
    total_us = sum(e.self_device_time_total for e in events)
    walk_us = sum(e.self_device_time_total for e in events
                  if any(name in e.key for name in _WALKERS))
    print('device busy %.3f s (idle share %.3f); walker kernel %.3f s '
          '(%.3f of busy)' % (total_us / 1e6, 1 - total_us / 1e6 / wall,
                              walk_us / 1e6, walk_us / max(total_us, 1)))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print('  %8.1f ms  %6d calls  %s' % (e.self_device_time_total / 1e3,
                                            e.count, e.key[:90]))


def report_spans(rec):
    """Count, total and self host ms of each of the program's spans."""
    totals = rec.totals()
    print('program spans (host ms): count, total, self')
    for name in sorted(totals):
        n, total, own = totals[name]
        print('  %-20s %7d %10.2f %10.2f' % (name, n, total / 1e6,
                                             own / 1e6))
    for name, n in sorted(rec.counts.items()):
        print('  counter %s %d' % (name, n))


def profile_eval_pdf(gg, card, nphotons=20000, nreps=2, ndaq=32):
    from chroma_tpu_torch.generator.photon import photon_bomb
    from chroma_tpu_torch.sim import Simulation
    sim = Simulation(gg, seed=1)
    ev = next(sim.simulate(
        photon_bomb(nphotons, 400.0, (0, 0, 0)).photons_beg, run_daq=True))

    def run():
        photons = photon_bomb(nphotons, 400.0, (0, 0, 0)).photons_beg
        torch.cuda.synchronize()
        t0 = time.time()
        sim.eval_pdf(ev.channels, photons, 0.2, (-0.5, 999.5), 1,
                     (-0.5, 9.5), nreps=nreps, ndaq=ndaq, min_bin_content=20)
        torch.cuda.synchronize()
        return time.time() - t0

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    print('%s: one eval_pdf, %d photons, nreps %d, ndaq %d: wall %.3f s '
          'under the profiler' % (card, nphotons, nreps, ndaq, wall))
    report(prof, wall)


def profile_render(gg, card, size=(800, 600), alpha_depth=10):
    from chroma_tpu_torch.camera import Camera
    cam = Camera(gg, size=size, alpha_depth=alpha_depth)

    def run():
        torch.cuda.synchronize()
        t0 = time.time()
        cam.render_to_array()
        return time.time() - t0

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    print('%s: one frame, %dx%d, alpha_depth %d: wall %.4f s under the '
          'profiler' % ((card,) + tuple(size) + (alpha_depth, wall)))
    report(prof, wall)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--nphotons', type=int, default=1 << 20)
    parser.add_argument('--detector', default='full')
    parser.add_argument('--driver', default='fused',
                        choices=('fused', 'steps'))
    parser.add_argument('--od-slots', type=int, default=1)
    parser.add_argument('--width', type=int, default=None)
    parser.add_argument('--service-every', type=int,
                        default=fused.SERVICE_EVERY)
    parser.add_argument('--sweep', action='store_true')
    parser.add_argument('--eval-pdf', action='store_true')
    parser.add_argument('--render', action='store_true')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    dev = torch.device('cuda')
    card = torch.cuda.get_device_name(0)
    gg = gpu.GPUDetector.from_table_cache(args.detector, device=dev)
    if gg is None:
        raise SystemExit("no '%s' table cache" % args.detector)
    if args.sweep:
        return sweep(gg, args, card)
    if args.eval_pdf:
        return profile_eval_pdf(gg, card)
    if args.render:
        return profile_render(gg, card)
    photons = benchmark._isotropic_photons(args.nphotons)
    rng = gpu.get_rng_states(seed=1, device=dev)
    kw = _driver_kw(args)
    gpu.GPUPhotons(photons, dev).propagate(gg, rng, **kw)
    p = gpu.GPUPhotons(photons, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            tracing.recording() as rec:
        t0 = time.time()
        p.propagate(gg, rng, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
    print('%s: %d photons, %s driver, %s; wall %.3f s, %.0f photons/s'
          % (card, args.nphotons, args.driver,
             _stats_line(p, args.nphotons, args.width, args.service_every),
             wall, args.nphotons / wall))
    report(prof, wall)
    report_spans(rec)


if __name__ == '__main__':
    main()

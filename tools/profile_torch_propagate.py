"""Where the time of one chroma_tpu_torch propagation goes, on one card.

    python tools/profile_torch_propagate.py [--nphotons N] [--detector full]

Loads the packed tables from the table cache ('full' is filled by
``chip_smoke.py``, under .cache/chroma_tpu in the checkout unless
CHROMA_TPU_CACHE says otherwise), propagates one isotropic 400 nm batch
from the centre once to warm up, then once under ``torch.profiler`` and
prints: wall time, the number of steps, the device time of the walker
kernel against all device time, the device's idle share over the run,
and the ten largest device kernels.  Needs a CUDA card.
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

from chroma_tpu_torch import benchmark, gpu  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--nphotons', type=int, default=1 << 20)
    parser.add_argument('--detector', default='full')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    dev = torch.device('cuda')
    gg = gpu.GPUDetector.from_table_cache(args.detector, device=dev)
    if gg is None:
        raise SystemExit("no '%s' table cache" % args.detector)
    photons = benchmark._isotropic_photons(args.nphotons)
    rng = gpu.get_rng_states(seed=1, device=dev)
    gpu.GPUPhotons(photons, dev).propagate(gg, rng)
    p = gpu.GPUPhotons(photons, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        p.propagate(gg, rng)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    walk_us = sum(e.self_device_time_total for e in events
                  if 'closest_hit_kernel' in e.key)
    print('%s: %d photons, %d steps, wall %.3f s, %.0f photons/s'
          % (torch.cuda.get_device_name(0), args.nphotons, p.last_steps,
             wall, args.nphotons / wall))
    print('device busy %.3f s (idle share %.3f); walker kernel %.3f s '
          '(%.3f of busy)' % (total_us / 1e6, 1 - total_us / 1e6 / wall,
                              walk_us / 1e6, walk_us / max(total_us, 1)))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print('  %8.1f ms  %6d calls  %s' % (e.self_device_time_total / 1e3,
                                            e.count, e.key[:90]))


if __name__ == '__main__':
    main()

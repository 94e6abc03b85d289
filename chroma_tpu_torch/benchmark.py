"""The five rates of chroma_tpu/benchmark.py on a detector: ray
intersections/s, photons loaded/s, photons propagated/s, PDF events/s and
PDF-eval events/s.

    python -m chroma_tpu_torch.benchmark --detector tiny \\
        --benchmarks ray,load,propagate,pdf,pdf_eval

Every timed region ends in ``torch.cuda.synchronize()`` on a CUDA
device, so the host clock measures finished device work.
"""
import argparse
import contextlib
import time

import numpy as np
import torch

from chroma_tpu_torch.event import Photons
from chroma_tpu_torch.sample import uniform_sphere
from chroma_tpu_torch.tools import argsort_direction
from chroma_tpu_torch import gpu
from chroma_tpu_torch.device import resolve
from chroma_tpu_torch.generator.photon import photon_bomb
from chroma_tpu_torch.ops import mbvh as mbvh_ops


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _center_rays(nphotons, seed=0, sort=True):
    """Isotropic unit directions from the origin (numpy, seeded)."""
    rng = np.random.RandomState(seed)
    dirs = rng.normal(size=(nphotons, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1)[:, None]
    if sort:
        dirs = dirs[argsort_direction(dirs)]
    pos = np.zeros((nphotons, 3), dtype=np.float32)
    return pos, dirs


def _isotropic_photons(nphotons, seed=0, wavelength=400.0):
    pos, dirs = _center_rays(nphotons, seed)
    pol = np.cross(uniform_sphere(nphotons), dirs).astype(np.float32)
    pol /= np.linalg.norm(pol, axis=1)[:, None]
    return Photons(pos=pos, dir=dirs, pol=pol,
                   wavelengths=np.full(nphotons, wavelength, np.float32))


def intersect(gpu_geometry, number=10, nphotons=500000):
    """Ray intersections/s from the detector center (reference:
    chroma/benchmark.py:22), after one warm-up run."""
    dev = gpu_geometry.device
    pos, dirs = _center_rays(nphotons)
    o = torch.from_numpy(pos).to(dev)
    d = torch.from_numpy(dirs).to(dev)
    mbvh_ops.intersect_mesh(o, d, gpu_geometry.geom)
    run_times = []
    for _ in range(number):
        _sync(dev)
        t0 = time.time()
        mbvh_ops.intersect_mesh(o, d, gpu_geometry.geom)
        _sync(dev)
        run_times.append(time.time() - t0)
    return nphotons / np.array(run_times)


def propagate(gpu_geometry, number=10, nphotons=500000, max_steps=100,
              seed=1, **driver):
    """Full-physics photons propagated/s (reference:
    chroma/benchmark.py:70), after one warm-up run.  ``driver`` goes to
    ``GPUPhotons.propagate`` (``driver='steps'`` times the step loop,
    ``od_slots``, ``width``, ``service_every`` the on-deck driver).
    Returns (rates, photons of the last run)."""
    dev = gpu_geometry.device
    rng_states = gpu.get_rng_states(seed=seed, device=dev)
    photons = _isotropic_photons(nphotons)
    gpu.GPUPhotons(photons, dev).propagate(gpu_geometry, rng_states,
                                           max_steps=max_steps, **driver)
    run_times = []
    for _ in range(number):
        gp = gpu.GPUPhotons(photons, dev)
        _sync(dev)          # upload finished before the clock starts
        t0 = time.time()
        gp.propagate(gpu_geometry, rng_states, max_steps=max_steps,
                     **driver)
        _sync(dev)
        run_times.append(time.time() - t0)
    return nphotons / np.array(run_times), gp


def load_photons(device=None, number=10, nphotons=500000):
    """Photons uploaded/s: host Photons to the device state of a
    ``GPUPhotons`` (reference: chroma/benchmark.py:48)."""
    photons = _isotropic_photons(nphotons)
    dev = resolve(device)
    run_times = []
    for _ in range(number):
        _sync(dev)
        t0 = time.time()
        gpu.GPUPhotons(photons, dev)
        _sync(dev)
        run_times.append(time.time() - t0)
    return nphotons / np.array(run_times)


def pdf(sim_obj, number=10, nphotons=100000, nbins=128):
    """PDF-filling events/s through ``Simulation.create_pdf``
    (reference: chroma/benchmark.py:99), one photon bomb an event."""
    run_times = []
    for _ in range(number):
        ev = photon_bomb(nphotons, 400.0, (0, 0, 0))
        _sync(sim_obj.device)
        t0 = time.time()
        sim_obj.create_pdf([ev.photons_beg], nbins, (-0.5, 999.5), 10,
                           (-0.5, 9.5))
        _sync(sim_obj.device)
        run_times.append(time.time() - t0)
    return 1.0 / np.array(run_times)


def pdf_eval(sim_obj, number=3, nphotons=20000, nreps=2, ndaq=32):
    """PDF-eval events/s through ``Simulation.eval_pdf`` (reference:
    chroma/benchmark.py:157): one simulated bomb is the observed event,
    a fresh bomb each run the hypothesis."""
    ev0 = next(sim_obj.simulate(
        photon_bomb(nphotons, 400.0, (0, 0, 0)).photons_beg, run_daq=True))
    run_times = []
    for _ in range(number):
        photons = photon_bomb(nphotons, 400.0, (0, 0, 0)).photons_beg
        _sync(sim_obj.device)
        t0 = time.time()
        sim_obj.eval_pdf(ev0.channels, photons, 0.2, (-0.5, 999.5), 1,
                         (-0.5, 9.5), nreps=nreps, ndaq=ndaq,
                         min_bin_content=20)
        _sync(sim_obj.device)
        run_times.append(time.time() - t0)
    return 1.0 / np.array(run_times)


@contextlib.contextmanager
def eval_pdf_sections(device):
    """While active, time the three device sections of
    ``Simulation.eval_pdf``: yields a dict that collects the seconds
    spent in ``GPUPhotons.propagate``, ``GPUDaq.acquire`` and
    ``GPUPDF.accumulate_pdf_eval``, each call between two device
    synchronizations (so the sections no longer overlap the host)."""
    seconds = dict(propagate=0.0, daq=0.0, pdf=0.0)
    targets = ((gpu.GPUPhotons, 'propagate', 'propagate'),
               (gpu.GPUDaq, 'acquire', 'daq'),
               (gpu.GPUPDF, 'accumulate_pdf_eval', 'pdf'))
    saved = [(cls, name, getattr(cls, name)) for cls, name, _ in targets]

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            _sync(device)
            t0 = time.time()
            out = fn(*args, **kwargs)
            _sync(device)
            seconds[key] += time.time() - t0
            return out
        return wrapper

    for (cls, name, fn), (_, _, key) in zip(saved, targets):
        setattr(cls, name, timed(fn, key))
    try:
        yield seconds
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def _report(name, rates, unit):
    """Print mean +/- std of the runs after the first; return the mean."""
    print('%s: %.3g +/- %.2g %s' % (name, rates[1:].mean(),
                                    rates[1:].std(), unit))
    return float(rates[1:].mean())


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='chroma_tpu_torch benchmarks')
    parser.add_argument('--detector', default='tiny',
                        choices=['tiny', 'full'])
    parser.add_argument('--nphotons', type=int, default=500000)
    parser.add_argument('--number', type=int, default=4)
    parser.add_argument('--benchmarks', default='ray,load,propagate',
                        help='comma list: ray,load,propagate,pdf,pdf_eval')
    parser.add_argument('--device', default=None,
                        help="default: the CUDA card; 'cpu' runs the plain "
                             'PyTorch versions')
    args = parser.parse_args(argv)

    from chroma_tpu_torch import demo
    from chroma_tpu_torch.sim import Simulation
    geo = demo.tiny() if args.detector == 'tiny' else demo.detector()
    sim_obj = Simulation(geo, seed=1, device=args.device)

    results = {}
    wanted = args.benchmarks.split(',')
    if 'ray' in wanted:
        results['ray_intersections_per_s'] = _report(
            'ray intersections', intersect(sim_obj.gpu_geometry,
                                           args.number, args.nphotons),
            'rays/s')
    if 'load' in wanted:
        results['photons_loaded_per_s'] = _report(
            'photons loaded', load_photons(sim_obj.device, args.number,
                                           args.nphotons), 'photons/s')
    if 'propagate' in wanted:
        results['photons_propagated_per_s'] = _report(
            'photons propagated', propagate(sim_obj.gpu_geometry,
                                            args.number, args.nphotons)[0],
            'photons/s')
    if 'pdf' in wanted:
        results['pdf_events_per_s'] = _report(
            'pdf events', pdf(sim_obj, max(args.number, 2)), 'events/s')
    if 'pdf_eval' in wanted:
        results['pdf_eval_events_per_s'] = _report(
            'pdf eval events', pdf_eval(sim_obj), 'events/s')
    return results


if __name__ == '__main__':
    main()

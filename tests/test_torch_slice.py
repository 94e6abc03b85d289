"""The port's whole slice against the JAX package's: Simulation.simulate
with DAQ on demo.tiny, through both of the port's drivers (the on-deck
lane-pool driver, its default, and the step loop), and the port's
freedom from JAX.

The two packages draw different random numbers (threefry keys against a
torch.Generator), so the comparison is statistical: the same numpy-seeded
photon bombs go through both Simulations, and the detection fraction
must agree within Poisson errors and the hit-time histograms within
chi^2/ndf < 2 (the test_golden.py thresholds).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from chroma_tpu import demo, event
from chroma_tpu.generator.photon import photon_bomb
from tests.test_golden import chi2_ndf

NEVENTS = 2
NPHOTONS = 10000
TIME_BINS = np.linspace(0.0, 40.0, 41)


def _bombs(seed, bomb=photon_bomb):
    np.random.seed(seed)
    return [bomb(NPHOTONS, 400.0, (200.0, 0.0, 0.0)).photons_beg
            for _ in range(NEVENTS)]


def _summarize(events):
    nhit = sum(len(ev.flat_hits) for ev in events)
    t = np.concatenate([ev.flat_hits.t for ev in events])
    chans = [int(np.asarray(ev.channels.hit).sum()) for ev in events]
    return nhit, np.histogram(t, TIME_BINS)[0].astype(float), chans


@pytest.fixture(scope='module')
def jax_events():
    from chroma_tpu.sim import Simulation as JaxSimulation
    jsim = JaxSimulation(demo.tiny(), geant4_processes=0, seed=21)
    return list(jsim.simulate(_bombs(5), run_daq=True,
                              keep_photons_end=True))


def _port_events(driver):
    """The same scene and photons, built with the port's own host layer
    (the same numpy draws give the same photons)."""
    from chroma_tpu_torch import host
    from chroma_tpu_torch.sim import Simulation
    psim = Simulation(host.demo.tiny(), seed=21, device='cpu', driver=driver)
    return list(psim.simulate(_bombs(5, host.photon_bomb), run_daq=True,
                              keep_photons_end=True))


@pytest.fixture(scope='module')
def both(jax_events):
    """JAX events and the port's, through its default on-deck driver."""
    return jax_events, _port_events('fused')


def test_simulate_detection_fraction_matches_jax(both):
    jev, pev = both
    jn, _, _ = _summarize(jev)
    pn, _, _ = _summarize(pev)
    assert jn > 300 and pn > 300
    # two independent Poisson counts: |a - b| within 4 sigma
    assert abs(jn - pn) < 4.0 * np.sqrt(jn + pn), (jn, pn)


def test_simulate_hit_times_match_jax(both):
    jev, pev = both
    _, jt, _ = _summarize(jev)
    _, pt, _ = _summarize(pev)
    assert chi2_ndf(jt, pt) < 2.0
    assert abs(int(np.argmax(jt)) - int(np.argmax(pt))) <= 1


def test_simulate_daq_channels_match_jax(both):
    """Each event's DAQ reads out about as many hit channels in both (the
    port digitizes a multi-event batch in one pass, by evidx); every hit
    channel's history word carries SURFACE_DETECT, nearly all carry
    charge, and >= 99% of photons end terminal."""
    jev, pev = both
    _, _, jc = _summarize(jev)
    _, _, pc = _summarize(pev)
    for a, b in zip(jc, pc):
        assert abs(a - b) <= 4.0 * np.sqrt(a + b + 1), (jc, pc)
    for ev in pev:
        ch = ev.channels
        assert ch.hit.any()
        assert (ch.flags[ch.hit] & event.SURFACE_DETECT).all()
        assert (ch.q[ch.hit] > 0).mean() > 0.9
        assert len(ev.photons_end) == NPHOTONS
        term = (ev.photons_end.flags & event.TERMINAL_FLAGS) != 0
        assert term.mean() >= 0.99


def test_simulate_step_driver_matches_jax(jax_events):
    """The step loop (driver='steps') against the JAX Simulation: the
    detection fraction within Poisson, hit times within chi^2/ndf < 2,
    >= 99% of photons terminal."""
    pev = _port_events('steps')
    jn, jt, _ = _summarize(jax_events)
    pn, pt, _ = _summarize(pev)
    assert abs(jn - pn) < 4.0 * np.sqrt(jn + pn), (jn, pn)
    assert chi2_ndf(jt, pt) < 2.0
    for ev in pev:
        term = (ev.photons_end.flags & event.TERMINAL_FLAGS) != 0
        assert term.mean() >= 0.99


def test_port_never_imports_jax():
    """Importing every module of the port and running a small propagation
    with DAQ (the on-deck driver, one and two slots, and the step loop)
    through Simulation must leave jax and every module of the JAX
    package chroma_tpu out of sys.modules."""
    code = '\n'.join([
        'import importlib, pkgutil, sys',
        'import numpy as np',
        'import chroma_tpu_torch',
        'for m in pkgutil.walk_packages(chroma_tpu_torch.__path__,',
        "                               'chroma_tpu_torch.'):",
        '    importlib.import_module(m.name)',
        'from chroma_tpu_torch.sim import Simulation',
        'from chroma_tpu_torch import host',
        "sim = Simulation(host.demo.tiny(), seed=3, device='cpu')",
        'np.random.seed(3)',
        'ph = host.photon_bomb(500, 400.0, (200.0, 0.0, 0.0)).photons_beg',
        'ev = next(sim.simulate([ph], run_daq=True))',
        'assert ev.channels is not None',
        'from chroma_tpu_torch import gpu',
        'for kw in (dict(od_slots=1), dict(od_slots=2), dict(driver="steps")):',
        '    p = gpu.GPUPhotons(ph, "cpu")',
        '    p.propagate(sim.gpu_geometry, sim.rng_states, **kw)',
        '    assert (p.last_stats is not None) != ("driver" in kw)',
        "bad = sorted(m for m in sys.modules if m in ('jax', 'chroma_tpu')",
        "             or m.startswith(('jax.', 'jaxlib', 'flax',",
        "                              'chroma_tpu.')))",
        "print('IMPORTED', bad)",
        'sys.exit(1 if bad else 0)',
    ])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert 'IMPORTED []' in proc.stdout


@pytest.mark.parametrize('entry', [
    'default_device', 'GPUPhotons', 'GPUGeometry', 'GPUDetector',
    'from_table_cache', 'get_rng_states', 'Simulation'])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """With no card and no ``device`` argument every entry point raises
    (naming device='cpu'); nothing falls back to the CPU."""
    import torch
    from chroma_tpu_torch import gpu, host
    from chroma_tpu_torch.sim import Simulation
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    np.random.seed(1)
    ph = host.photon_bomb(10, 400.0, (0.0, 0.0, 0.0)).photons_beg
    geo = host.mesh_geometry(host.make.sphere(10.0, nsteps=8))
    call = dict(default_device=gpu.default_device,
                GPUPhotons=lambda: gpu.GPUPhotons(ph),
                GPUGeometry=lambda: gpu.GPUGeometry(geo),
                GPUDetector=lambda: gpu.GPUDetector(geo),
                from_table_cache=lambda: gpu.GPUDetector.from_table_cache(
                    'absent'),
                get_rng_states=lambda: gpu.get_rng_states(seed=1),
                Simulation=lambda: Simulation(geo, seed=1))[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    # the CPU, named, still works
    assert gpu.GPUPhotons(ph, 'cpu').pos.device.type == 'cpu'


def test_gpu_photons_copies_select_and_hits():
    """GPUPhotons API: ncopies replicate the batch, iterate_copies and
    select slice it, get_hits groups the detected photons by channel."""
    from chroma_tpu_torch import gpu
    det = demo.tiny()
    det.flatten()
    gd = gpu.GPUDetector(det, 'cpu')
    np.random.seed(9)
    ph = photon_bomb(2000, 400.0, (200.0, 0.0, 0.0)).photons_beg
    p = gpu.GPUPhotons(ph, 'cpu', ncopies=2)
    assert len(p) == 4000 and p.stride == 2000
    p.propagate(gd, gpu.get_rng_states(seed=2, device='cpu'))
    copies = list(p.iterate_copies())
    assert [len(c) for c in copies] == [2000, 2000]
    end = p.get()
    assert np.array_equal(end.pos[:2000] != 0, copies[0].get().pos != 0)
    sel = p.select(event.SURFACE_DETECT, start_photon=2000, nphotons=2000)
    flags = sel.get().flags
    assert len(sel) > 0 and ((flags & event.SURFACE_DETECT) != 0).all()
    hits = p.get_hits(gd)
    flat = p.get_flat_hits(gd)
    assert sum(len(v) for v in hits.values()) == len(flat)
    assert len(flat) == int(((end.flags & event.SURFACE_DETECT) != 0).sum())
    assert set(hits) <= set(range(gd.nchannels))

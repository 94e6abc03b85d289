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
import jax  # noqa: F401  (imported before torch, as the test files do)
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

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
    """Importing every module of the port (the Geant4 backend under the
    fake bindings) and chip_smoke.py, and running a small propagation
    with DAQ (the on-deck driver, one and two slots, and the step loop)
    through Simulation, a likelihood evaluation, a PDF fill, a tracked
    propagation, a gun event through the generator pool into an event
    file, a served request in both protocols, a rendered frame, a
    hybrid render, a SNO-like GDML detector through the RAT loader, CSG
    booleans on both backends, the demo models, the BVH tools, the geo
    and bvh commands on a temporary cache, the ntuple writer (under
    tests/fake_uproot.py), a simulation sharded over ['cpu', 'cpu'], a
    parabola fit and a wavelength colour map must leave jax and every
    module of the JAX package chroma_tpu out of sys.modules."""
    code = '\n'.join([
        'import importlib, itertools, os, pkgutil, sys, tempfile',
        'import numpy as np',
        'import tests.fake_geant4 as fake_geant4',
        "sys.modules['geant4_pybind'] = fake_geant4.make_fake()",
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
        'from chroma_tpu_torch.likelihood import Likelihood',
        'def bombs():',
        '    while True:',
        '        yield host.photon_bomb(300, 400.0, (0.0, 0.0, 0.0)).photons_beg',
        'lik = Likelihood(sim, event=ev)',
        'nll = lik.eval(bombs(), nevals=1, nreps=1, ndaq=2)',
        'assert np.isfinite(nll.nominal_value)',
        'sim.create_pdf(ph, 8, (-0.5, 99.5), 2, (-0.5, 9.5))',
        'tracks = gpu.GPUPhotons(ph, "cpu").propagate(',
        '    sim.gpu_geometry, sim.rng_states, max_steps=3, track=True)',
        'assert len(tracks[1]) >= 2',
        "names = {m.name for m in pkgutil.walk_packages(",
        "    chroma_tpu_torch.__path__, 'chroma_tpu_torch.')}",
        "for name in ('pi0', 'camera', 'histogram.histogram',",
        "             'generator.vertex', 'generator.trackgen',",
        "             'generator.g4gen', 'io.npz', 'cli.sim', 'cli.server',",
        "             'cli.cam', 'ops.render', 'ops.hybrid', 'csg',",
        "             'rat', 'rat.gdml', 'rat.loader', 'rat.ratdb_parser',",
        "             'models', 'bvh.optimize', 'bvh.bvh', 'bvh.build',",
        "             'cli.geo', 'cli.bvh', 'io.root', 'io.ntuple',",
        "             'parallel', 'parabola', 'color', 'color.colormap',",
        "             'histogram.histogramdd', 'histogram.graph', 'tools',",
        "             'ops.mesh', 'ops.intersect'):",
        "    assert 'chroma_tpu_torch.' + name in names, name",
        "    assert 'chroma_tpu_torch.' + name in sys.modules, name",
        'import chip_smoke',
        'from chroma_tpu_torch.generator.photon import HAVE_ZMQ',
        'from chroma_tpu_torch.generator.vertex import constant_particle_gun',
        'from chroma_tpu_torch.io.npz import NpzReader, NpzWriter',
        'from chroma_tpu_torch.cli.server import ChromaRATServer, ChromaServer',
        'from chroma_tpu_torch.camera import Camera',
        'if HAVE_ZMQ:',
        "    gsim = Simulation(sim.gpu_geometry, seed=3, geant4_processes=1)",
        "    gun = constant_particle_gun('e-', (0, 0, 0), (1, 0, 0), 5.0)",
        '    gev = list(gsim.simulate(itertools.islice(gun, 2), run_daq=True))',
        '    gsim.close()',
        '    assert len(gev) == 2 and gev[0].nphotons > 0',
        "    path = os.path.join(tempfile.mkdtemp(), 'ev.npz')",
        '    with NpzWriter(path) as w:',
        '        w.write_event(gev[0])',
        '    assert len(NpzReader(path)) == 1',
        'assert len(ChromaServer(None, sim.gpu_geometry).answer(ph)) == 500',
        'msg = chip_smoke.rat_request(ph, 3)',
        'reply = ChromaRATServer(None, sim.gpu_geometry).answer(msg)',
        'assert chip_smoke.rat_reply(reply)[0] == 3',
        'cam = Camera(sim.gpu_geometry, size=(16, 12))',
        'assert cam.render_to_array().shape == (12, 16, 3)',
        'from chroma_tpu_torch.ops.hybrid import HybridRenderer',
        'hyb = HybridRenderer(sim.gpu_geometry)',
        'hyb.ntriangles = 64',
        'hyb.update_xyz_lookup((0.0, 0.0, 0.0))',
        'assert hyb.render(cam.rays.pos, cam.rays.dir).shape == (192, 3)',
        'from chroma_tpu_torch import csg, make, models',
        'from chroma_tpu_torch.rat import RATGeoLoader',
        "tmp = tempfile.mkdtemp()",
        "gdml, ratdb = chip_smoke.sno_like_gdml(3, os.path.join(tmp, 'd.gdml'))",
        'rl = RATGeoLoader(gdml, ratdb_file=ratdb)',
        'rl.add_pmt_info()',
        'sno = rl.build_detector(volume_classifier=chip_smoke.sno_classifier)',
        'assert sno.num_channels() == 3',
        'sno_sim = Simulation(sno, seed=3, device="cpu")',
        'assert next(sno_sim.simulate([ph])).photons_end is None',
        'a, b = make.cube(10.0), make.sphere(6.0, nsteps=6)',
        "assert len(csg.boolean('subtraction', a, b).triangles) > 0",
        "assert len(csg._boolean_python('union', a, b).triangles) > 0",
        'assert len(models.lionsolid().mesh.triangles) > 0',
        'from chroma_tpu_torch.bvh import make_simple_bvh, optimize',
        'tree = optimize.area_sort_children(make_simple_bvh(a, degree=3))',
        'assert optimize.layer_area(tree.nodes) > 0',
        "os.environ['CHROMA_TPU_CACHE'] = os.path.join(tmp, 'cache')",
        'from chroma_tpu_torch.cli import bvh as cli_bvh, geo as cli_geo',
        "cli_geo.main(['save', '@chroma_tpu_torch.models.companioncube', 'cc'])",
        "cli_bvh.main(['create', 'cc:g', '3'])",
        "cli_bvh.main(['optimize', 'cc:g'])",
        'import tests.fake_uproot as fake_uproot',
        'fake_uproot.install()',
        "importlib.reload(importlib.import_module('chroma_tpu_torch.io.ntuple'))",
        'from chroma_tpu_torch.io.ntuple import NTupleWriter',
        "with NTupleWriter(os.path.join(tmp, 'e.root'), detector=sno) as w:",
        '    w.write_event(ev)',
        "msim = Simulation(sim.gpu_geometry, seed=3, devices=['cpu', 'cpu'])",
        'assert msim.mesh.size == 2',
        'mev = next(msim.simulate([ph], run_daq=True, keep_photons_end=True))',
        'assert len(mev.photons_end) == 500 and mev.channels is not None',
        'from chroma_tpu_torch.parabola import parabola_fit',
        'from chroma_tpu_torch.color import map_wavelength',
        'x = np.random.RandomState(0).uniform(-1, 1, (20, 2))',
        'assert np.isfinite(parabola_fit(x, (x ** 2).sum(axis=1))[4])',
        'assert map_wavelength([450.0]).shape == (1, 3)',
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
    'from_table_cache', 'get_rng_states', 'Simulation',
    'tables_from_numpy', 'pack_geometry', 'pack_detector', 'load_tables',
    'make_photon_state', 'ondeck_empty', 'walker_state_from_jax',
    'load_photons', 'GPURays', 'Camera', 'ChromaServer', 'ChromaRATServer',
    'cli_sim', 'cli_cam', 'cli_server', 'make_photon_mesh',
    'Simulation_devices', 'referee_main'])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """With no card and no ``device`` argument every entry point and
    every public function that makes tensors raises (naming
    device='cpu'); nothing falls back to the CPU."""
    import torch
    from chroma_tpu_torch import benchmark, gpu, host, parallel, referee
    from chroma_tpu_torch.ops import geometry_pack, mbvh_walk, propagate, \
        table_cache
    from chroma_tpu_torch.camera import Camera
    from chroma_tpu_torch.cli import cam, server, sim
    from chroma_tpu_torch.ops.render import GPURays
    from chroma_tpu_torch.sim import Simulation
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    scene = '@chroma_tpu_torch.host.tie_geometry'

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
                Simulation=lambda: Simulation(geo, seed=1),
                tables_from_numpy=lambda: geometry_pack.tables_from_numpy(
                    {}, None, {}),
                pack_geometry=lambda: geometry_pack.pack_geometry(geo),
                pack_detector=lambda: geometry_pack.pack_detector(geo),
                load_tables=lambda: table_cache.load_tables('absent'),
                make_photon_state=lambda: propagate.make_photon_state(4),
                ondeck_empty=lambda: mbvh_walk.ondeck_empty(4),
                walker_state_from_jax=lambda: mbvh_walk.walker_state_from_jax(
                    {}, 2, False),
                load_photons=lambda: benchmark.load_photons(
                    number=1, nphotons=10),
                GPURays=lambda: GPURays(ph.pos, ph.dir),
                Camera=lambda: Camera(geo, size=(4, 3)),
                ChromaServer=lambda: server.ChromaServer(None, geo),
                ChromaRATServer=lambda: server.ChromaRATServer(None, geo),
                cli_sim=lambda: sim.main([scene, '-g', '0']),
                cli_cam=lambda: cam.main([scene, '-o', 'unwritten.png']),
                cli_server=lambda: server.main(
                    [scene, '-a', 'ipc:///tmp/chroma_tpu_torch_unbound']),
                make_photon_mesh=parallel.make_photon_mesh,
                Simulation_devices=lambda: Simulation(geo, seed=1,
                                                      devices=None),
                referee_main=lambda: referee.main(['tiny']))[entry]
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

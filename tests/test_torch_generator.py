"""The port's photon generation against the JAX package's: pi0 decay,
the vertex guns, the track generator, the Geant4 backend under the fake
bindings, the worker pool, and Simulation fed vertices.

The generators are numpy code drawing from a ``RandomState`` and from
the global ``np.random``; from the same seeds both packages must make
the same vertices and photons bit for bit (tolerance: none).  Where the
device propagation follows (Simulation), the two packages draw different
random numbers on the device, so detected fractions are compared within
5 sigma of their Poisson errors.
"""
import copy
import importlib
import itertools
import json
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

from chroma_tpu import event as jevent
from chroma_tpu import pi0 as jpi0
from chroma_tpu.demo.optics import water as jwater
from chroma_tpu.generator import vertex as jvertex
from chroma_tpu.generator.trackgen import TrackGenerator as JTrackGenerator
from chroma_tpu_torch import event as pevent
from chroma_tpu_torch import pi0 as ppi0
from chroma_tpu_torch.demo.optics import water as pwater
from chroma_tpu_torch.generator import vertex as pvertex
from chroma_tpu_torch.generator.photon import (G4ParallelGenerator,
                                               GeneratorProcess, HAVE_ZMQ)
from chroma_tpu_torch.generator.trackgen import TrackGenerator

needs_zmq = pytest.mark.skipif(not HAVE_ZMQ, reason='pyzmq missing')

PHOTON_FIELDS = ('pos', 'dir', 'pol', 'wavelengths', 't', 'flags',
                 'weights', 'evidx', 'last_hit_triangles')
STEP_FIELDS = ('x', 'y', 'z', 't', 'dx', 'dy', 'dz', 'ke', 'edep', 'qedep')


def assert_photons_equal(a, b):
    assert len(a) == len(b)
    for f in PHOTON_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        assert np.array_equal(x, y), f


def assert_vertex_equal(a, b):
    assert a.particle_name == b.particle_name
    assert a.pdgcode == b.pdgcode and a.trackid == b.trackid
    for f in ('pos', 'dir', 'ke', 't0'):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f
    assert (a.steps is None) == (b.steps is None)
    if a.steps is not None:
        for f in STEP_FIELDS:
            assert np.array_equal(np.asarray(getattr(a.steps, f)),
                                  np.asarray(getattr(b.steps, f))), f
    ac, bc = a.children or [], b.children or []
    assert len(ac) == len(bc)
    for x, y in zip(ac, bc):
        assert_vertex_equal(x, y)


def _scint(material):
    mat = copy.deepcopy(material)
    lam = np.linspace(350.0, 450.0, 21)
    mat.scintillation_spectrum = np.column_stack([lam, np.ones_like(lam)])
    mat.scintillation_light_yield = 100.0        # photons / MeV
    mat.scintillation_waveform = np.array([[-10.0, 1.0]])
    return mat


# ---- pi0, guns --------------------------------------------------------

@pytest.mark.parametrize('energy,theta,phi', [
    (200.0, 0.3, 1.1), (135.5, 2.0, -0.4), (1000.0, 1.5707, 3.0)])
def test_pi0_decay_bit_equal(energy, theta, phi):
    d = np.array([0.2, -0.5, 0.7])
    for (je, jd), (pe, pd) in zip(jpi0.pi0_decay(energy, d, theta, phi),
                                  ppi0.pi0_decay(energy, d, theta, phi)):
        assert je == pe and np.array_equal(jd, pd)
    assert jpi0.PI0_MASS == ppi0.PI0_MASS


@pytest.mark.parametrize('particle,direction', [
    ('e-', (1, 0, 0)), ('mu-', (0, 0, 0)), ('pi0', (0, 1, 0)),
    ('pi0', (0, 0, 0))])
def test_constant_particle_gun_bit_equal(particle, direction):
    """Fixed and isotropic (zero direction, global np.random) guns and
    the pi0 gun make the same vertices in both packages."""
    out = []
    for mod in (jvertex, pvertex):
        np.random.seed(17)
        out.append(list(itertools.islice(mod.constant_particle_gun(
            particle, (1.0, 2.0, 3.0), direction, 250.0, t0=1.5,
            start_id=4), 5)))
    for jev, pev in zip(*out):
        assert jev.id == pev.id
        assert len(jev.vertices) == len(pev.vertices) \
            == (2 if particle == 'pi0' else 1)
        for a, b in zip(jev.vertices, pev.vertices):
            assert_vertex_equal(a, b)
        if particle == 'pi0':
            assert_vertex_equal(jev.primary_vertex, pev.primary_vertex)
    assert isinstance(out[1][0], pevent.Event)
    assert isinstance(out[1][0].vertices[0], pevent.Vertex)


def test_vertex_iterators_bit_equal():
    """from_histogram (the port's own Histogram), flat, line_segment and
    fill_shell draw the same values from the same global seed."""
    from chroma_tpu.histogram import Histogram as JHistogram
    from chroma_tpu_torch.histogram import Histogram
    vals = np.random.RandomState(3).normal(5.0, 1.5, 400)
    out = []
    for mod, hcls in ((jvertex, JHistogram), (pvertex, Histogram)):
        h = hcls(10, (0.0, 10.0))
        h.fill(vals)
        np.random.seed(8)
        take = lambda it: list(itertools.islice(it, 6))  # noqa: E731
        out.append(np.concatenate([
            np.ravel(take(mod.from_histogram(h))),
            np.ravel(take(mod.flat(1.0, 3.0))),
            np.ravel(take(mod.line_segment(np.zeros(3), np.ones(3)))),
            np.ravel(take(mod.fill_shell(np.ones(3), 20.0)))]))
    assert np.array_equal(out[0], out[1])


# ---- TrackGenerator ---------------------------------------------------

@pytest.mark.parametrize('particle,ke,scint', [
    ('e-', 5.0, False),       # tracked electron (below the shower cut)
    ('e-', 100.0, False),     # parameterized EM shower
    ('mu-', 300.0, False),    # heavy charged track
    ('gamma', 20.0, False),   # conversion, children
    ('e-', 3.0, True),        # scintillating material
    ('alpha', 5.0, True),     # heavily quenched scintillation
])
def test_track_generator_bit_equal(particle, ke, scint):
    """Same RandomState seed and same global np.random seed: the port's
    TrackGenerator makes the JAX package's photons, steps and children,
    bit for bit."""
    out = []
    for ev, gen_cls, mat in ((jevent, JTrackGenerator, jwater),
                             (pevent, TrackGenerator, pwater)):
        mat = _scint(mat) if scint else mat
        np.random.seed(29)
        gen = gen_cls(mat, rng=np.random.RandomState(31))
        verts = [ev.Vertex(particle, np.array([10.0, -5.0, 2.0]),
                           np.array([0.0, 0.6, 0.8]), ke, t0=2.0)]
        out.append((verts, gen.generate_photons(verts),
                    gen.generate_photons(verts)))
    (jv, jp1, jp2), (pv, pp1, pp2) = out
    assert isinstance(pp1, pevent.Photons) and len(pp1) > 0
    assert_photons_equal(jp1, pp1)
    assert_photons_equal(jp2, pp2)    # the generators' state moved alike
    assert_vertex_equal(jv[0], pv[0])
    created = pevent.SCINTILLATION if scint and particle == 'alpha' \
        else (pevent.CHERENKOV | pevent.SCINTILLATION if scint
              else pevent.CHERENKOV)
    assert ((pp1.flags & created) != 0).all()


def test_trackgen_extends_the_ports_particle_masses():
    """trackgen adds the kaon masses to ``event.PARTICLE_MASS_MEV`` when
    it is imported: the port's copy extends the port's table."""
    assert pevent.PARTICLE_MASS_MEV['kaon+'] == 493.677
    assert pevent.PARTICLE_MASS_MEV is not jevent.PARTICLE_MASS_MEV
    assert pevent.PARTICLE_MASS_MEV == jevent.PARTICLE_MASS_MEV


# ---- the Geant4 backend under the fake bindings -----------------------
# the four cases of tests/test_g4gen_contract.py, against the port's module

HBARC_MEV_NM = 197.3269804e-6


@pytest.fixture()
def g4gen(monkeypatch):
    import tests.fake_geant4 as fg
    monkeypatch.setitem(sys.modules, 'geant4_pybind', fg.make_fake())
    sys.modules.pop('chroma_tpu_torch.generator.g4gen', None)
    mod = importlib.import_module('chroma_tpu_torch.generator.g4gen')
    yield mod
    sys.modules.pop('chroma_tpu_torch.generator.g4gen', None)


def test_g4_material_conversion(g4gen):
    g4mat = g4gen.create_g4material(_scint(pwater))
    e, v = g4mat.table.props['RINDEX']
    assert all(b > a for a, b in zip(e, e[1:]))   # ascending energies
    assert 'SCINTILLATIONYIELD' in g4mat.table.consts
    assert g4mat.table.consts['SCINTILLATIONTIMECONSTANT1'] == 10.0
    assert g4mat.elements  # composition transferred


def test_g4_generate_photons_harvest_and_scint(g4gen):
    gen = g4gen.G4Generator(_scint(pwater), seed=12)
    v = pevent.Vertex('e-', (10.0, 0.0, 0.0), (0.0, 0.0, 1.0), 1.0)
    photons = gen.generate_photons([v])
    assert isinstance(photons, pevent.Photons)
    cher = (photons.flags & pevent.CHERENKOV) != 0
    scint = (photons.flags & pevent.SCINTILLATION) != 0
    # exactly the one scripted Cherenkov photon, at 2.5 eV
    assert cher.sum() == 1
    expect_wl = 2 * np.pi * HBARC_MEV_NM / 2.5e-6
    np.testing.assert_allclose(photons.wavelengths[cher], expect_wl,
                               rtol=1e-5)
    np.testing.assert_allclose(photons.pol[cher][0], [0.0, 0.0, 1.0])
    # scintillation from 1 MeV deposited at 100 photons/MeV
    assert 60 < scint.sum() < 160
    sp = photons.pos[scint]
    np.testing.assert_allclose(sp[:, 0], 10.0, atol=1e-5)
    assert (sp[:, 2] >= -1e-5).all() and (sp[:, 2] <= 8.0 + 1e-5).all()
    wl = photons.wavelengths[scint]
    assert (wl >= 349.0).all() and (wl <= 451.0).all()


def test_g4_tracking_vertex_tree(g4gen):
    gen = g4gen.G4Generator(_scint(pwater), seed=5)
    v = pevent.Vertex('e-', (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), 2.0)
    tracked, photons, parent_ids = gen.generate_photons([v], tracking=True)
    assert len(tracked) == 1
    tv = tracked[0]
    assert isinstance(tv, pevent.Vertex)
    assert tv.particle_name == 'e-' and tv.pdgcode == 11
    assert len(tv.steps.x) == 3
    np.testing.assert_allclose(tv.steps.z, [0.0, 5.0, 8.0], atol=1e-6)
    np.testing.assert_allclose(np.sum(tv.steps.edep), 2.0, rtol=1e-6)
    assert tv.children == []
    assert len(parent_ids) == len(photons)
    assert (parent_ids == 1).all()


def test_g4_schema_matches_trackgen(g4gen):
    mat = _scint(pwater)
    g4photons = g4gen.G4Generator(mat, seed=3).generate_photons(
        [pevent.Vertex('e-', (0, 0, 0), (0, 0, 1), 1.0)])
    tphotons = TrackGenerator(mat, seed=3).generate_photons(
        [pevent.Vertex('e-', (0, 0, 0), (0, 0, 1), 1.0)])
    for attr in ('pos', 'dir', 'pol', 'wavelengths', 't', 'flags',
                 'weights', 'evidx'):
        a, b = getattr(g4photons, attr), getattr(tphotons, attr)
        assert a.dtype == b.dtype, attr
        assert a.shape[1:] == b.shape[1:], attr


def test_make_generator_falls_to_trackgen_without_geant4():
    """No Geant4 bindings here: the pool's backend is the TrackGenerator,
    seeded as the JAX package seeds it."""
    from chroma_tpu_torch.generator.photon import _make_generator
    gen = _make_generator(pwater, 7)
    assert isinstance(gen, TrackGenerator)
    assert gen.rng.randint(1 << 30) == \
        np.random.RandomState(7).randint(1 << 30)


# ---- the worker pool --------------------------------------------------

def _alive(processes):
    for p in processes:
        p.join(timeout=10.0)
    return [p.is_alive() for p in processes]


@needs_zmq
def test_parallel_generator_produces_photons():
    """Two spawned workers, six electron-gun events: ids 0..5 (possibly
    out of order), photons in every event; no worker outlives close()."""
    gun = pvertex.constant_particle_gun('e-', (0, 0, 0), (1, 0, 0), 10.0)
    with G4ParallelGenerator(2, pwater, base_seed=42) as gen:
        processes = list(gen.processes)
        assert all(isinstance(p, GeneratorProcess) for p in processes)
        events = list(gen.generate_events(itertools.islice(gun, 6)))
    assert sorted(ev.id for ev in events) == list(range(6))
    for ev in events:
        assert isinstance(ev.photons_beg, pevent.Photons)
        assert len(ev.photons_beg) > 0
        assert ev.nphotons == len(ev.photons_beg)
    assert _alive(processes) == [False, False]
    for address in (gen.vertex_address, gen.photon_address):
        assert not os.path.exists(address[len('ipc://'):])


def run_jax_side(code, *args):
    """Run ``code`` in a fresh interpreter from the repository root and
    return the JSON object it prints on its last line.  The JAX package's
    generator pool forks; a fork of this test process, which holds JAX's
    and PyTorch's threads and a ZMQ context, can deadlock or kill it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, '-c', 'import tests.conftest\n' + code, *args],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


JAX_POOL = """
import itertools, json, sys
import numpy as np
from chroma_tpu.demo.optics import water
from chroma_tpu.generator import vertex
from chroma_tpu.generator.photon import G4ParallelGenerator
from chroma_tpu.io.npz import NpzWriter
np.random.seed(77)
gen = G4ParallelGenerator(1, water, base_seed=1234)
try:
    gun = vertex.constant_particle_gun('e-', (0, 0, 0), (1, 0, 0), 8.0)
    evs = sorted(gen.generate_events(itertools.islice(gun, 3)),
                 key=lambda ev: ev.id)
finally:
    procs = list(gen.processes)
    gen.__del__()
for p in procs:
    p.join(timeout=10.0)
with NpzWriter(sys.argv[1]) as w:
    for ev in evs:
        w.write_event(ev)
print(json.dumps({'nphotons': [ev.nphotons for ev in evs],
                  'alive': [p.is_alive() for p in procs]}))
"""


@needs_zmq
def test_parallel_generator_matches_jax_pool(tmp_path):
    """One worker each, the same worker seed and the same global numpy
    state when the pool starts (the JAX package's forked worker inherits
    it, the port's spawned worker is handed it): the same events come
    back, photon for photon.  The JAX pool runs in a fresh interpreter
    and hands its events over in an npz file, which the port reads."""
    from chroma_tpu_torch.io.npz import NpzReader
    path = str(tmp_path / 'jax_pool.npz')
    jax_side = run_jax_side(JAX_POOL, path)
    assert jax_side['alive'] == [False]
    np.random.seed(77)
    gen = G4ParallelGenerator(1, pwater, base_seed=1234)
    try:
        gun = pvertex.constant_particle_gun('e-', (0, 0, 0), (1, 0, 0), 8.0)
        evs = list(gen.generate_events(itertools.islice(gun, 3)))
    finally:
        procs = list(gen.processes)
        gen.__del__()
    assert _alive(procs) == [False]
    pevs = sorted(evs, key=lambda ev: ev.id)
    jevs = list(NpzReader(path))
    assert [ev.id for ev in jevs] == [ev.id for ev in pevs] == [0, 1, 2]
    for n, jev, pev in zip(jax_side['nphotons'], jevs, pevs):
        assert n == pev.nphotons == len(jev.photons_beg) > 0
        assert_photons_equal(jev.photons_beg, pev.photons_beg)


@needs_zmq
def test_pool_raises_when_a_worker_dies():
    """A dead worker fails the caller; it does not hang it."""
    gun = pvertex.constant_particle_gun('e-', (0, 0, 0), (1, 0, 0), 5.0)
    with G4ParallelGenerator(1, pwater, base_seed=5) as gen:
        gen._wait_for_ready()
        gen.processes[0].terminate()
        gen.processes[0].join(timeout=10.0)
        with pytest.raises(RuntimeError, match='died'):
            list(gen.generate_events(itertools.islice(gun, 2)))


# ---- Simulation fed vertices ------------------------------------------

NGUN = 6


def _gun(mod, n=NGUN):
    return itertools.islice(mod.constant_particle_gun(
        'e-', (0, 0, 0), (1, 0, 0), 10.0), n)


def _fraction(events):
    nhit = sum(len(ev.flat_hits) for ev in events)
    return nhit, sum(ev.nphotons for ev in events)


@pytest.fixture(scope='module')
def port_sim():
    from chroma_tpu_torch import demo
    from chroma_tpu_torch.sim import Simulation
    sim = Simulation(demo.tiny(), seed=11, geant4_processes=2, device='cpu')
    processes = list(sim.photon_generator.processes)
    yield sim
    sim.close()
    assert sim.photon_generator is None
    assert _alive(processes) == [False, False]


JAX_SIMULATION = """
import itertools, json
from chroma_tpu import demo
from chroma_tpu.generator import vertex
from chroma_tpu.sim import Simulation
sim = Simulation(demo.tiny(), seed=11, geant4_processes=2)
try:
    gun = itertools.islice(vertex.constant_particle_gun(
        'e-', (0, 0, 0), (1, 0, 0), 10.0), %d)
    evs = list(sim.simulate((ev.vertices[0] for ev in gun), run_daq=True))
finally:
    sim.photon_generator.__del__()
print(json.dumps({'nhit': sum(len(ev.flat_hits) for ev in evs),
                  'nphotons': sum(ev.nphotons for ev in evs)}))
""" % NGUN


@needs_zmq
def test_simulate_vertices_matches_jax(port_sim):
    """Vertex input through the pool, propagation and DAQ on demo.tiny:
    events come back with ids in order of arrival, hits and channels;
    the detected fraction agrees with the JAX Simulation's over the same
    gun within 5 sigma.  The JAX Simulation, whose pool forks, runs in a
    fresh interpreter and reports its hit and photon counts."""
    jax_side = run_jax_side(JAX_SIMULATION)
    pev = list(port_sim.simulate(
        (ev.vertices[0] for ev in _gun(pvertex)), run_daq=True,
        keep_photons_end=True))
    assert [ev.id for ev in pev] == list(range(NGUN))
    for ev in pev:
        assert ev.nphotons > 0 and len(ev.photons_end) == ev.nphotons
        assert ev.channels.hit.any() and len(ev.flat_hits) > 0
        assert set(ev.hits) <= set(range(port_sim.gpu_geometry.nchannels))
        assert ev.photons_beg is None
    jn, jtot = jax_side['nhit'], jax_side['nphotons']
    pn, ptot = _fraction(pev)
    assert jn > 50 and pn > 50
    diff = jn / jtot - pn / ptot
    sigma = np.sqrt(jn / jtot ** 2 + pn / ptot ** 2)
    assert abs(diff) < 5.0 * sigma, (jn, jtot, pn, ptot)


@needs_zmq
def test_simulate_photonless_events_and_create_pdf(port_sim):
    """Photon-less Events (the guns' own output) go through the pool;
    ``create_pdf`` takes vertex input too."""
    evs = list(port_sim.simulate(_gun(pvertex, 3), keep_photons_beg=True,
                                 evid_start=10))
    assert [ev.id for ev in evs] == [10, 11, 12]
    for ev in evs:
        assert len(ev.photons_beg) == ev.nphotons > 0
        assert ((ev.photons_beg.flags & pevent.CHERENKOV) != 0).all()
        assert ev.vertices[0].particle_name == 'e-'
    hitcount, pdf = port_sim.create_pdf(
        (ev.vertices[0] for ev in _gun(pvertex, 3)), 10, (-0.5, 99.5),
        4, (-0.5, 9.5))
    assert hitcount.sum() > 0 and pdf.sum() > 0
    assert pdf.shape == (port_sim.gpu_geometry.nchannels, 10, 4)


def test_simulation_without_pool_rejects_vertices():
    from chroma_tpu_torch import host
    from chroma_tpu_torch.sim import Simulation
    sim = Simulation(host.mesh_geometry(host.make.sphere(10.0, nsteps=8)),
                     seed=1, device='cpu')
    assert sim.photon_generator is None
    with pytest.raises(RuntimeError, match='geant4_processes=0'):
        list(sim.simulate(_gun(pvertex, 1)))
    sim.close()

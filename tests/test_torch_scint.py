"""The benchmark's SNO+-like scintillator deployment (``portbench``'s
``snoplus_like`` configuration and ``scint_point`` source) on the CPU:

* the GDML writer's scintillator goes through the port's RAT loader and
  packs two reemitting components whose tables equal the written ones
  at the grid points; the JAX package's loader reads the same tables;
* the point-event bank: Poisson counts, vertices inside the vessel,
  isotropic photons, the spectrum's stratified quantiles, delays;
* ``Simulation.simulate`` against the plain reference
  (``reference/check_scint.py``) within the cell's own limits, and each
  planted fault (``no_reemit``, ``fluor_abs``) failing them;
* the step loop with reemission against the JAX package's on injected
  draws (tests/test_torch_propagate.py's form and bounds), and the same
  bit for bit with the program's recorder on;
* a photon reemitted along an axis (a uniform draw of exactly 0 at the
  pole): the step loop's walk takes the hit the walker gives the exact
  direction, visiting a small share of the rows that walk visits.

The program-against-reference cases run a compact detector: the SNO-like
writer with its PMT sphere at 1.5 m and its vessel at 1 m (the writer's
module constants patched) and 270 PMTs, which covers the sphere as the
full detector's 9,438 cover theirs.  So ~20,000 photons from vertices
near the center give ~470 crossed and ~160 reemitted clean direct
detections in a few seconds of the CPU walker.
"""
import json
import os

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import event as jevent
from chroma_tpu.detector import Detector as JDetector
from chroma_tpu.ops import geometry_pack as jgp
from chroma_tpu.ops import photon as jphoton
from chroma_tpu.rat import RATGeoLoader as JRATGeoLoader
from chroma_tpu_torch import event, gpu, tracing
from chroma_tpu_torch.detector import Detector
from chroma_tpu_torch.ops import geometry_pack as tgp
from chroma_tpu_torch.ops import mbvh, mbvh_walk
from chroma_tpu_torch.ops import photon as tphoton
from chroma_tpu_torch.ops import propagate as tprop
from chroma_tpu_torch.rat import RATGeoLoader
from portbench import generator, plugins
from portbench.configs import sno_like_gdml, snoplus_like
from portbench.reference import check_scint, scint
from tests.test_torch_propagate import DRIVER_RTOL, _compare, _to_port
from tests.test_torch_tables import port_tables

CELL = 'snoplus_like-scint2p5m16m.steps'
BENCH = plugins.BENCH_DIR
with open(os.path.join(BENCH, 'configs', 'snoplus_like.json')) as _f:
    CFG = json.load(_f)
with open(os.path.join(BENCH, 'traffic', 'scint2p5m16m.steps.json')) as _f:
    TRAFFIC = json.load(_f)
with open(os.path.join(BENCH, 'limits', CELL + '.json')) as _f:
    LIMITS = {k: v['limit'] for k, v in json.load(_f)['numbers'].items()}
SCINT = CFG['scintillator']
SEED = 2 ** 31 + 1717
# the compact detector (mm) and its traffic
PSUP, AV, NPMT = 1500.0, 1000.0, 270
VERTEX_RADIUS = 300.0
EVENTS, ENERGY = 8, 0.2
FAULT_EVENTS = 3


def _load(loader_cls, detector_cls, path):
    loader = loader_cls(path, ratdb_file=path + '.ratdb.json')
    loader.add_pmt_info()
    inner = loader.materials_used[loader.material_lookup['scintillator']]
    det = loader.build_detector(detector=detector_cls(inner),
                                volume_classifier=snoplus_like.sno_like
                                ._sno_classifier)
    det.flatten()
    return det


@pytest.fixture(scope='module')
def compact(tmp_path_factory):
    """(configuration, the port's detector, its tables, the reference)
    of the compact detector."""
    cfg = dict(CFG, npmt=NPMT, channels=NPMT, psup_radius_mm=PSUP,
               av_radius_mm=AV, search_radius_mm=PSUP - 30.0,
               fiducial_radius_mm=AV)
    path = str(tmp_path_factory.mktemp('snoplus') / 'compact.gdml')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sno_like_gdml, 'SNO_PSUP_RADIUS', PSUP)
        mp.setattr(sno_like_gdml, 'SNO_AV_RADIUS', AV)
        snoplus_like.gdml.snoplus_like_gdml(NPMT, path, SCINT)
        ref = snoplus_like.reference(cfg, torch.device('cpu'))
    det = _load(RATGeoLoader, Detector, path)
    return cfg, det, gpu.GPUDetector(det, 'cpu'), ref


def _row(geom):
    return snoplus_like._scintillator_row(geom)


def _at_nodes(geom, table):
    """``table`` (..., W) at the configuration's wavelength nodes."""
    lam = np.asarray(SCINT['wavelength_nm'], dtype=np.float64)
    k = np.rint((lam - geom.wavelength0) / geom.wavelength_step).astype(int)
    return table.cpu().numpy().astype(np.float64)[..., k]


def test_writer_packs_two_reemitting_components(compact):
    _, det, gg, _ = compact
    geom = gg.geom
    assert geom.has_reemission and geom.max_comp == 2
    m = _row(geom)
    assert int(geom.num_comp[m]) == 2
    comp = np.asarray(SCINT['abslength_mm'], dtype=np.float64)
    rtol = 2e-6
    np.testing.assert_allclose(
        _at_nodes(geom, geom.comp_absorption_length[m]), comp, rtol=rtol)
    np.testing.assert_allclose(
        _at_nodes(geom, geom.absorption_length[m]),
        1.0 / (1.0 / comp).sum(0), rtol=rtol)
    np.testing.assert_allclose(
        _at_nodes(geom, geom.scattering_length[m]), SCINT['rslength_mm'],
        rtol=rtol)
    np.testing.assert_allclose(
        _at_nodes(geom, geom.refractive_index[m]), SCINT['rindex'],
        rtol=rtol)
    prob = _at_nodes(geom, geom.comp_reemission_prob[m])
    for c, p in enumerate(SCINT['reemission_prob']):
        np.testing.assert_allclose(prob[c], p, rtol=rtol)
    # the reemission spectrum's CDF, each component's, at the nodes: the
    # reference's (trapezoid rule at the nodes), 0 below and 1 above
    spec = scint.Spectrum(SCINT['wavelength_nm'], SCINT['emission'])
    want = np.interp(SCINT['wavelength_nm'], spec.x, spec.cdf)
    cdf = _at_nodes(geom, geom.comp_reemission_wvl_cdf[m])
    for c in range(2):
        np.testing.assert_allclose(cdf[c], want, atol=2e-6)
    # each delay's CDF: an exponential of its component's decay time
    # (the loader integrates the written density by the trapezoid rule,
    # 8 points a decay time: within 2e-3)
    times = geom.time0 + geom.time_step * np.arange(geom.ntimes)
    for c, tau in enumerate(SCINT['reemission_tau_ns']):
        got = geom.comp_reemission_time_cdf[m, c].numpy()
        sel = times <= 8.0 * tau
        np.testing.assert_allclose(got[sel],
                                   1.0 - np.exp(-times[sel] / tau),
                                   atol=2e-3)


def test_jax_loader_reads_the_same_scintillator(tmp_path):
    """The JAX package's loader and packer read the written scintillator
    into the same material tables (bit for bit), from a file of 12
    PMTs."""
    path, _ = snoplus_like.gdml.snoplus_like_gdml(
        12, str(tmp_path / 's.gdml'), SCINT)
    jgeom, _ = jgp.pack_detector(_load(JRATGeoLoader, JDetector, path))
    pgeom, _ = tgp.pack_detector(_load(RATGeoLoader, Detector, path),
                                 'cpu')
    for name in ('refractive_index', 'absorption_length',
                 'scattering_length', 'num_comp', 'comp_reemission_prob',
                 'comp_reemission_wvl_cdf', 'comp_reemission_time_cdf',
                 'comp_absorption_length', 'comp_reemission_wvl_icdf',
                 'comp_reemission_time_icdf'):
        assert np.array_equal(np.asarray(getattr(jgeom, name)),
                              getattr(pgeom, name).numpy()), name
    assert jgeom.has_reemission and pgeom.has_reemission
    assert jgeom.max_comp == pgeom.max_comp == 2


def _bank(source, seed=SEED):
    return plugins.find(BENCH, 'sources', 'scint_point').make_bank(
        source, CFG, generator.stream_seeds(seed)['bank'],
        torch.device('cpu'))


def test_scint_point_bank():
    K, energy = 64, 0.1
    source = dict(TRAFFIC['source'], bank_events=K, energy_mev=energy)
    bank = _bank(source)
    counts = np.diff(bank['offsets'])
    mean = source['light_yield_per_mev'] * energy
    # Poisson: mean and variance both ~1,192
    assert abs(counts.mean() - mean) < 4.0 * np.sqrt(mean / K)
    assert 0.5 * mean < counts.var() < 1.6 * mean
    vertex, t0 = bank['meta']['vertex'], bank['meta']['time']
    assert (np.linalg.norm(vertex, axis=1)
            < source['vertex_radius_mm']).all()
    ev = np.repeat(np.arange(K), counts)
    assert np.array_equal(bank['pos'], vertex.astype(np.float32)[ev])
    d, pol = bank['dir'].astype(np.float64), bank['pol'].astype(np.float64)
    n = len(d)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(pol, axis=1), 1.0, atol=1e-6)
    assert np.abs((d * pol).sum(1)).max() < 1e-6
    # isotropic: the mean direction and the second moments
    assert np.linalg.norm(d.mean(0)) < 4.0 * np.sqrt(1.0 / n)
    np.testing.assert_allclose((d * d).mean(0), 1.0 / 3.0,
                               atol=8.0 * np.sqrt(4.0 / 45.0 / n))
    # delays: after the vertex time, with the time profile's mean
    delay = bank['t'].astype(np.float64) - t0[ev]
    assert delay.min() >= -1e-4
    prof = SCINT['time_profile']
    w = np.asarray(prof['weight']) / np.sum(prof['weight'])
    tau = np.asarray(prof['tau_ns'])
    mean_delay = (w * tau).sum()
    sd = np.sqrt((w * 2 * tau ** 2).sum() - mean_delay ** 2)
    assert abs(delay.mean() - mean_delay) < 4.0 * sd / np.sqrt(n)
    # every event's wavelengths: distinct, and the spectrum's quantiles
    # (i + 1/2) / N in some order
    spec = scint.Spectrum(SCINT['wavelength_nm'], SCINT['emission'],
                          *source['wavelength_nm'])
    for k in range(K):
        lam = np.sort(bank['wavelengths'][bank['offsets'][k]:
                                          bank['offsets'][k + 1]])
        assert (np.diff(lam) > 0).all()
        F = (np.arange(len(lam)) + 0.5) / len(lam)
        want = spec.quantile(torch.as_tensor(F)).numpy().astype(np.float32)
        assert np.array_equal(lam, want)


def _simulate(gg, cfg, ref, events):
    source = dict(TRAFFIC['source'], bank_events=events, energy_mev=ENERGY,
                  vertex_radius_mm=VERTEX_RADIUS)
    seeds = generator.stream_seeds(SEED)
    bank = plugins.find(BENCH, 'sources', 'scint_point').make_bank(
        source, cfg, seeds['bank'], torch.device('cpu'))
    traffic = dict(TRAFFIC, photons_per_batch=int(bank['offsets'][-1]))
    entry = plugins.find(BENCH, 'entries', 'simulate').Entry(
        gg, traffic, bank, seeds, torch.device('cpu'))
    ids, _ = entry.next()
    assert len(ids) == events
    samples = entry.samples([(ids, entry.call(ids))], events, seeds['check'])
    return check_scint.compare(ref, samples, torch.device('cpu'))


def test_program_against_the_plain_reference(compact):
    cfg, _, gg, ref = compact
    r = _simulate(gg, cfg, ref, EVENTS)
    c = r['counts']
    assert c['crossed_observed'] > 300 and c['reemit_observed'] > 100, c
    for name, limit in LIMITS.items():
        assert r[name] <= limit, (name, r[name], c)


@pytest.mark.parametrize('fault', sorted(snoplus_like.FAULTS))
def test_check_sees_the_fault(compact, fault):
    cfg, det, _, ref = compact
    gg = snoplus_like.FAULTS[fault](gpu.GPUDetector(det, 'cpu'), cfg)
    r = _simulate(gg, cfg, ref, FAULT_EVENTS)
    assert any(r[name] > limit for name, limit in LIMITS.items()), r


@pytest.fixture(scope='module')
def jax_scene(tmp_path_factory):
    """(JAX tables, the port's tables holding the same arrays, uploaded
    JAX photons): 512 photons of a point event in the SNO+-like
    detector at 12 PMTs, built by the JAX package's loader."""
    path = str(tmp_path_factory.mktemp('snoplus_jax') / 's.gdml')
    snoplus_like.gdml.snoplus_like_gdml(12, path, SCINT)
    jgeom, jdet = jgp.pack_detector(_load(JRATGeoLoader, JDetector, path))
    pgeom, _ = port_tables(jgeom, jdet)
    bank = _bank(dict(TRAFFIC['source'], bank_events=1, energy_mev=0.06))
    sl = slice(0, 512)
    photons = jevent.Photons(pos=bank['pos'][sl], dir=bank['dir'][sl],
                             pol=bank['pol'][sl],
                             wavelengths=bank['wavelengths'][sl],
                             t=bank['t'][sl])
    return jgeom, pgeom, jphoton.upload_photons(photons)


def test_step_loop_with_reemission_matches_jax(jax_scene):
    jgeom, pgeom, state = jax_scene
    assert pgeom.has_reemission and pgeom.max_comp == 2
    ref, ref_steps = jphoton.propagate(state, jgeom, jax.random.PRNGKey(11),
                                       max_steps=10)
    outs = []
    for on in (False, True):
        keys = [jax.random.PRNGKey(11)]

        def draws():
            # the same key chain as the JAX driver: split, then draw
            keys[0], sk = jax.random.split(keys[0])
            return torch.from_numpy(np.array(jax.random.uniform(
                sk, (512, tprop.NDRAWS), dtype=jax.numpy.float32)))

        if on:
            with tracing.recording() as rec:
                out, steps = tphoton.propagate(_to_port(state), pgeom, draws,
                                               max_steps=10)
            assert rec.totals()['step.reemit'][0] == steps
        else:
            out, steps = tphoton.propagate(_to_port(state), pgeom, draws,
                                           max_steps=10)
        assert steps == int(ref_steps)
        outs.append(out)
    same, err = _compare(ref, outs[0])
    assert same.mean() >= 0.99
    assert err <= DRIVER_RTOL
    flags = outs[0]['flags'].numpy().view(np.uint32)
    assert ((flags & event.BULK_REEMIT) != 0).sum() >= 50
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_an_axis_parallel_photon_walks_like_any_other(compact, monkeypatch):
    """``uniform_sphere`` at a pole gives (0, -0, -1): 1/dir is infinite
    on two axes and the walker's slab test takes every box of the
    column.  The step loop walks it with ``AXIS_TINY`` in place of the
    zeros: the same hit as the exact direction's walk, in a small share
    of its rows (on the full SNO-like table the exact walk outruns
    max_iters)."""
    _, _, gg, _ = compact
    geom = gg.geom
    d = tprop.uniform_sphere(torch.tensor([0.25]), torch.tensor([0.0]))
    assert d[0, 0] == 0 and d[0, 1] == 0 and d[0, 2] == -1
    pos = torch.tensor([[101.5, -203.25, 302.75]])
    lht = torch.tensor([-1], dtype=torch.int32)
    exact = {}
    ref = mbvh_walk.closest_hit_plain(
        geom.mbvh_rows, pos, d, lht, torch.ones(1, dtype=torch.bool),
        mbvh.tquant_scale(geom), int(geom.mbvh_depth),
        bool(geom.mbvh_instanced), 65536, work=exact)
    assert not bool(ref['incomplete'][0]) and int(ref['triangle'][0]) >= 0
    walked, seen = {}, {}
    plain = mbvh_walk.closest_hit_plain

    def counted(*args, **kwargs):
        out = plain(*args, work=walked, **kwargs)
        seen.update(out)
        return out
    monkeypatch.setattr(mbvh_walk, 'closest_hit_plain', counted)
    state = tprop.make_photon_state(
        pos=pos, dir=d, pol=torch.tensor([[1.0, 0.0, 0.0]]),
        wavelength=torch.tensor([450.0]), device='cpu')
    tprop.propagate_step(state, geom, torch.full((1, tprop.NDRAWS), 0.5))
    assert int(seen['triangle'][0]) == int(ref['triangle'][0])
    assert float(seen['distance'][0]) == pytest.approx(
        float(ref['distance'][0]), rel=1e-6)
    rows = exact['cluster_rows'] + exact['internal_rows']
    assert walked['cluster_rows'] + walked['internal_rows'] < rows / 10

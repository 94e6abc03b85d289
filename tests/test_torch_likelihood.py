"""The reconstruction path of chroma_tpu_torch against the JAX package's:
``Simulation.create_pdf`` / ``eval_pdf`` / ``setup_kernel`` /
``eval_kernel``, ``Likelihood`` and photon tracking, on the four-PMT box
of tests/test_likelihood.py (each package builds it with its own host
modules; the port runs on the CPU through its default on-deck driver).

The packages draw different random numbers, so counts are compared
statistically, within 5 sigma of the difference of two independent
binomial counts:

* ``create_pdf``: per channel, the number of 40 repetitions of a
  300-photon bomb in which the channel read out inside the histogram;
* ``eval_pdf`` (weighted, scatter-stratified propagation, multi-DAQ):
  per channel, the hit probability hitcount / (nevals * nreps * ndaq).
  The ndaq readouts of one propagated copy share their photons, so the
  sigma counts nevals * nreps independent samples, not all the readouts.

``Likelihood.eval`` (time only, and the 2D time-charge estimator) and
``eval_kernel`` at the JAX test's sizes (3000 photons, nevals 2, nreps 2,
ndaq 8): finite, and lower at the true vertex than at its mirror image.

Tracking mode: from the same generator seed the last snapshot equals
``driver='steps'`` bit for bit, and ``Simulation(photon_tracking=True)``
fills one polyline per photon, from its origin to its end.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax  # noqa: F401  (imported before torch, as the test files do)
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import make as jmake
from chroma_tpu.demo.optics import r7081hqe_photocathode as jphotocathode
from chroma_tpu.detector import Detector as JDetector
from chroma_tpu.generator.photon import photon_bomb as jphoton_bomb
from chroma_tpu.geometry import Solid as JSolid, vacuum as jvacuum
from chroma_tpu.likelihood import Likelihood as JLikelihood
from chroma_tpu.loader import create_geometry_from_obj
from chroma_tpu.sim import Simulation as JSimulation
from chroma_tpu_torch import event, gpu, host
from chroma_tpu_torch.demo.optics import r7081hqe_photocathode
from chroma_tpu_torch.detector import Detector
from chroma_tpu_torch.geometry import Solid, vacuum
from chroma_tpu_torch.likelihood import Likelihood, UFloat
from chroma_tpu_torch.sim import Simulation

TRANGE = (-0.5, 200.0)
QRANGE = (-0.5, 49.5)
TRUE_POS = (400.0, 0.0, 0.0)


def _four_pmt_box(detector_cls, solid_cls, box, vac, surface):
    """One 400 x 400 mm PMT face on each of the +-x and +-y sides, 1 m
    from the centre (tests/test_likelihood.py's detector)."""
    det = detector_cls(vac)
    pmt = solid_cls(box(400.0, 400.0, 40.0), vac, vac, surface=surface)
    rot_y = np.array([[0, 0, 1.], [0, 1, 0], [-1., 0, 0]])
    rot_x = np.array([[1., 0, 0], [0, 0, 1.], [0, -1., 0]])
    det.add_pmt(pmt, rotation=rot_y, displacement=(1000.0, 0, 0))
    det.add_pmt(pmt, rotation=rot_y, displacement=(-1000.0, 0, 0))
    det.add_pmt(pmt, rotation=rot_x, displacement=(0, 1000.0, 0))
    det.add_pmt(pmt, rotation=rot_x, displacement=(0, -1000.0, 0))
    det.set_time_dist_gaussian(1.2, -6.0, 6.0)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    return det


@pytest.fixture(scope='module')
def jsim():
    det = _four_pmt_box(JDetector, JSolid, jmake.box, jvacuum, jphotocathode)
    geo = create_geometry_from_obj(det, update_bvh_cache=False)
    return JSimulation(geo, geant4_processes=0, seed=99)


@pytest.fixture(scope='module')
def psim():
    det = _four_pmt_box(Detector, Solid, host.make.box, vacuum,
                        r7081hqe_photocathode)
    sim = Simulation(det, seed=99, device='cpu')
    assert sim.gpu_pdf is not None and sim.gpu_pdf_kernel is not None
    assert sim.gpu_daq.ndaq == 1
    return sim


def _bombs(bomb, pos, n=3000, t0=20.0):
    while True:
        yield bomb(n, 400.0, pos, t0=t0).photons_beg


def _binomial_close(a, b, n):
    """Two counts of n trials each, within 5 sigma of each other (with
    half a count of slack for n * p near 0 or n)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    p = (a + b) / (2.0 * n)
    sigma = np.sqrt(2.0 * n * p * (1.0 - p))
    return np.all(np.abs(a - b) <= 5.0 * sigma + 0.5), (a, b, sigma)


def test_create_pdf_hit_counts_match_jax(jsim, psim):
    nreps, args = 40, (16, TRANGE, 5, QRANGE)
    np.random.seed(2)
    jhit, jpdf = jsim.create_pdf(
        jphoton_bomb(300, 400.0, TRUE_POS, t0=20.0).photons_beg, *args,
        nreps=nreps)
    phit, ppdf = psim.create_pdf(
        host.photon_bomb(300, 400.0, TRUE_POS, t0=20.0).photons_beg, *args,
        nreps=nreps)
    assert phit.dtype == ppdf.dtype == np.uint32
    assert ppdf.shape == jpdf.shape == (4, 16, 5)
    assert np.array_equal(ppdf.sum(axis=(1, 2)), phit)
    ok, detail = _binomial_close(jhit, phit, nreps)
    assert ok, detail
    # the near PMT reads out in most events, the far one in fewer
    assert phit[0] > phit[1] and 0 < phit[1] < nreps
    # the same configuration again clears the histogram, not the setup
    phit2, _ = psim.create_pdf(
        host.photon_bomb(300, 400.0, TRUE_POS, t0=20.0).photons_beg, *args)
    assert psim.gpu_pdf.events_in_histogram == nreps + 1
    assert phit2.max() <= 1


def test_eval_pdf_hit_probabilities_match_jax(jsim, psim):
    nevals, nreps, ndaq = 10, 4, 8
    np.random.seed(3)
    pev = next(psim.simulate(host.photon_bomb(300, 400.0, TRUE_POS,
                                              t0=20.0).photons_beg,
                             run_daq=True))
    probs = []
    for lik, bomb in ((JLikelihood(jsim, event=pev, trange=TRANGE),
                       jphoton_bomb),
                      (Likelihood(psim, event=pev, trange=TRANGE),
                       host.photon_bomb)):
        hit_prob, pdf_prob, pdf_err = lik.eval_channel_vbin(
            _bombs(bomb, TRUE_POS, n=300), nevals, nreps=nreps, ndaq=ndaq,
            min_bin_content=20)
        assert np.isfinite(pdf_prob).all() and (pdf_prob > 0).all()
        assert np.isfinite(pdf_err).all()
        probs.append(hit_prob)
    assert ((probs[1] > 0) & (probs[1] < 1)).all()
    n = nevals * nreps
    ok, detail = _binomial_close(probs[0] * n, probs[1] * n, n)
    assert ok, detail


@pytest.mark.parametrize('time_only', [True, False])
def test_likelihood_discriminates_position(psim, time_only):
    """NLL of the observed event is lower at the true source position
    than at its mirror image (time only, and the 2D estimator)."""
    np.random.seed(4 + time_only)
    ev = next(psim.simulate(host.photon_bomb(3000, 400.0, TRUE_POS,
                                             t0=20.0).photons_beg,
                            run_daq=True))
    assert ev.channels.hit.any()
    lik = Likelihood(psim, event=ev, trange=TRANGE, time_only=time_only)
    right = lik.eval(_bombs(host.photon_bomb, TRUE_POS), nevals=2, nreps=2,
                     ndaq=8)
    wrong = lik.eval(_bombs(host.photon_bomb, (-400.0, 0.0, 0.0)), nevals=2,
                     nreps=2, ndaq=8)
    assert isinstance(right, UFloat)
    assert np.isfinite(right.nominal_value) and np.isfinite(right.std_dev)
    assert np.isfinite(wrong.nominal_value)
    assert right.nominal_value < wrong.nominal_value


@pytest.mark.parametrize('time_only', [True, False])
def test_likelihood_kernel_estimator(psim, time_only):
    np.random.seed(6)
    ev = next(psim.simulate(host.photon_bomb(3000, 400.0, TRUE_POS,
                                             t0=20.0).photons_beg,
                            run_daq=True))
    lik = Likelihood(psim, event=ev, trange=TRANGE, qrange=(-0.5, 999.5),
                     time_only=time_only)
    lik.setup_kernel(_bombs(host.photon_bomb, TRUE_POS), nevals=2, nreps=2,
                     ndaq=4, oversample_factor=2)
    assert (psim.gpu_pdf_kernel.inv_time_bandwidths > 0).all()
    nll = lik.eval_kernel(_bombs(host.photon_bomb, TRUE_POS), nevals=2,
                          nreps=2, ndaq=4, navg=2)
    assert np.isfinite(nll.nominal_value) and np.isfinite(nll.std_dev)
    hitcount, values, _ = psim.gpu_pdf_kernel.get_kernel_eval()
    assert hitcount.dtype == np.uint32 and (hitcount == 2 * 2 * 4).all()
    assert (values > 0).all()


def test_ufloat_arithmetic():
    a = UFloat(1.0, 3.0) + UFloat(2.0, 4.0)
    assert (a.nominal_value, a.std_dev) == (3.0, 5.0)
    b = -(2.5 + a)
    assert (b.nominal_value, b.std_dev, float(b)) == (-5.5, 5.0, -5.5)


def test_eval_pdf_rejects_vertices(psim):
    """Vertex input needs the generator pool: a Simulation made with
    ``geant4_processes=0`` says so plainly, as the JAX package's does."""
    ev = event.Event(vertices=[event.Vertex('e-', (0, 0, 0), (1, 0, 0),
                                            1.0)])
    with pytest.raises(RuntimeError, match='geant4_processes=0'):
        psim.create_pdf([ev], 16, TRANGE, 5, QRANGE)
    with pytest.raises(TypeError):
        list(psim.simulate([3]))


def test_tracking_matches_step_loop(psim):
    """One ``propagate_step`` per host step over the whole batch, a
    snapshot after each: the last equals the step loop's result from the
    same seed bit for bit (each photon reads the draw row of its index
    in both), and step 0 is the upload."""
    np.random.seed(8)
    ph = host.photon_bomb(500, 400.0, (100.0, 50.0, 0.0)).photons_beg
    tracked = gpu.GPUPhotons(ph, 'cpu')
    ids, snaps = tracked.propagate(
        psim.gpu_geometry, gpu.get_rng_states(seed=5, device='cpu'),
        max_steps=20, track=True)
    stepped = gpu.GPUPhotons(ph, 'cpu')
    stepped.propagate(psim.gpu_geometry,
                      gpu.get_rng_states(seed=5, device='cpu'),
                      max_steps=20, driver='steps')
    assert tracked.last_steps == stepped.last_steps == len(snaps) - 1 > 1
    assert all(np.array_equal(i, np.arange(500)) for i in ids)
    assert np.array_equal(snaps[0].pos, ph.pos)
    for k, v in stepped.state.items():
        assert torch.equal(tracked.state[k], v), k
    assert np.array_equal(snaps[-1].pos, stepped.get().pos)
    assert np.array_equal(snaps[-1].flags, stepped.get().flags)


def test_simulation_photon_tracking_fills_tracks():
    det = _four_pmt_box(Detector, Solid, host.make.box, vacuum,
                        r7081hqe_photocathode)
    sim = Simulation(det, seed=7, device='cpu', photon_tracking=True)
    np.random.seed(9)
    bombs = [host.photon_bomb(n, 400.0, (0.0, 0.0, 0.0)).photons_beg
             for n in (60, 40)]
    events = list(sim.simulate(bombs, keep_photons_end=True, max_steps=10))
    assert [len(ev.photon_tracks) for ev in events] == [60, 40]
    for ev in events:
        nsteps = {len(t) for t in ev.photon_tracks}
        assert len(nsteps) == 1 and nsteps.pop() >= 2
        first = np.stack([t.pos[0] for t in ev.photon_tracks])
        last = np.stack([t.pos[-1] for t in ev.photon_tracks])
        assert not first.any()
        assert np.array_equal(last, ev.photons_end.pos)

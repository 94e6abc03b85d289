"""The comparison that decides ``correct`` in a scintillator: the timed
path's own output for a sample of point events, held against the plain
reference (``reference/scint.py``).

A photon that was not reemitted keeps its wavelength, so it is held as
``check.py`` holds every photon; a reemitted one (``BULK_REEMIT``) drew
a new wavelength and a new direction somewhere in the scintillator, so
it is held to what any photon of its event must obey.  Five numbers,
each with a limit of its own (``limits/<cell>.json``):

* ``hits_bad``: the share of the sampled events' detected photons that
  fail a check of their own.  Not reemitted: ``check.check_hits``'s (one
  the event emitted, on its channel's photocathode, causal, and a direct
  one on its reference ray at its time).  Reemitted: on its channel's
  photocathode, no sooner than light could arrive on the straight line
  from its event's vertex (every photon of a point event starts there),
  and a wavelength inside the emission spectrum's support.
* ``yield_crossed_dev``: ``check.py``'s, over the photons that were not
  reemitted: every ray starts in the scintillator and crosses the
  vessel, attenuated by the scintillator's total absorption plus its
  scattering.
* ``reemit_yield_dev``: |observed / expected - 1| for the clean direct
  detections of reemitted photons: detected photons whose history holds
  ``BULK_REEMIT`` and no scatter or reflection, entering a PMT's clean
  region.  The expectation is a plain Monte Carlo over the sampled
  events' emitted photons, ``DRAWS`` chains each
  (``scint.expected_reemitted``).
* ``yield_dev``: the same for every clean direct detection, reemitted
  or not: the two yields' observed sum over their expected sum.  No
  photon of a point event in the vessel reaches a PMT uncrossed, so
  ``check.py``'s uncrossed yield has nothing to count here.
* ``daq_bad``: ``check.check_daq``'s.
"""
import numpy as np
import torch

from portbench.reference import check, optics, scint

# chains a photon in the reemission Monte Carlo, and its seed: the same
# sample always gets the same expectation
DRAWS = 4
SEED = 20210817
# nm: a reemitted wavelength may lie this far outside the spectrum's
# support (float32 at 500 nm is 3e-5 nm apart)
SUPPORT_TOL_NM = 1e-3


def check_reemitted(ref, emitted, hits, device):
    """(bad, why, clean) for the reemitted detected photons of one
    event: the reasons of the bad ones, and which entered a PMT's clean
    region with nothing but a reemission in their history."""
    n = len(hits['t'])
    why = dict(reemit_surface=0, reemit_too_early=0, out_of_spectrum=0,
               reemit_channel=0)
    if n == 0:
        return np.zeros(0, dtype=bool), why, np.zeros(0, dtype=bool)
    npmt = ref.centers.shape[0]
    ch = np.asarray(hits['channel']).astype(np.int64)
    valid = (ch >= 0) & (ch < npmt)
    j = torch.as_tensor(np.where(valid, ch, 0), device=device)
    hp = check._t(hits['pos'], device)
    th = check._t(hits['t'], device)
    lam = check._t(hits['wavelengths'], device)
    vertex = check._t(emitted['pos'][:1], device)
    t0 = float(np.min(emitted['t']))
    res = ref.surface_residual(hp - ref.centers[j], ref.axes[j])
    on_surface = res <= ref.surface_tol_mm
    fast = t0 + torch.linalg.norm(hp - vertex, dim=-1) \
        * ref.media.n_min(lam) / optics.C_MM_PER_NS
    causal = th >= fast - ref.time_tol_ns
    spectrum = ref.scint.spectrum
    inside = (lam >= spectrum.lo - SUPPORT_TOL_NM) \
        & (lam <= spectrum.hi + SUPPORT_TOL_NM)
    ok = (on_surface & causal & inside).cpu().numpy() & valid
    for k, m in (('reemit_surface', ~on_surface),
                 ('reemit_too_early', ~causal),
                 ('out_of_spectrum', ~inside)):
        why[k] = int(m.sum())
    why['reemit_channel'] = int((~valid).sum())
    flags = np.asarray(hits['flags']).astype(np.int64)
    only = (flags & optics.INDIRECT) == optics.BULK_REEMIT
    lands = ref.clean_hit(hp - ref.centers[j],
                          optics.normalize(check._t(hits['dir'], device)),
                          ref.axes[j]).cpu().numpy()
    return ~ok, why, only & valid & lands


def _subset(hits, keep):
    return {k: np.asarray(v)[keep] for k, v in hits.items()}


def compare(ref, samples, device):
    """Readings of the numbers over ``samples``: (emitted, hits,
    channels) triples, each a dict of numpy arrays."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    bad = total = direct = obs_x = obs_r = emitted_n = 0
    exp_x = exp_r = per_photon = generations = 0.0
    daq_bad = daq_total = 0
    why = {}
    for emitted, hits, channels in samples:
        flags = np.asarray(hits['flags']).astype(np.int64)
        re = (flags & optics.BULK_REEMIT) != 0
        b, n, dr, _, _, ox, ex, w = check.check_hits(
            ref, emitted, _subset(hits, ~re), device)
        rbad, rwhy, rclean = check_reemitted(ref, emitted,
                                             _subset(hits, re), device)
        for k, v in list(w.items()) + list(rwhy.items()):
            why[k] = why.get(k, 0) + v
        bad += b + int(rbad.sum())
        total += n + int(re.sum())
        direct += dr
        obs_x += ox
        exp_x += ex
        obs_r += int(rclean.sum())
        e, share, gens = scint.expected_reemitted(
            ref, check._t(emitted['pos'], device),
            optics.normalize(check._t(emitted['dir'], device)),
            check._t(emitted['wavelengths'], device), ref.inner_radius,
            DRAWS, gen)
        m = len(emitted['t'])
        exp_r += e
        per_photon += share * m
        generations += gens * share * m
        emitted_n += m
        db, dt = check.check_daq(ref, hits, channels)
        daq_bad += db
        daq_total += dt

    def dev(o, e):
        return abs(o / e - 1.0) if e > 0 else 1.0
    return dict(
        hits_bad=bad / total if total else 0.0,
        yield_dev=dev(obs_x + obs_r, exp_x + exp_r),
        yield_crossed_dev=dev(obs_x, exp_x),
        reemit_yield_dev=dev(obs_r, exp_r),
        daq_bad=daq_bad / daq_total if daq_total else 1.0,
        counts=dict(hits=total, direct=direct, crossed_observed=obs_x,
                    crossed_expected=exp_x, reemit_observed=obs_r,
                    reemit_expected=exp_r,
                    reemitted_per_photon_expected=per_photon / emitted_n
                    if emitted_n else 0.0,
                    generations_per_reemitted=generations / per_photon
                    if per_photon else 0.0,
                    channels=daq_total, failed=why))

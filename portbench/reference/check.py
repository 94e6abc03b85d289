"""The comparison that decides ``correct``: the timed path's own output
for a sample of events, held against the plain reference.

Four numbers, each with a limit of its own (``limits/<cell>.json``):

* ``hits_bad``: the share of the sampled events' detected photons that
  fail a check of their own.  Every detected photon must be one the
  event emitted (its wavelength names it), lie on the photocathode of
  the channel it reports, and arrive no sooner than light could on the
  straight line.  A direct one (no scatter, reflection or reemission in
  its history) must also lie on the reference's ray from its start,
  refracted at every spherical boundary, and arrive at that ray's time.
  This covers the walker's closest hit, the geometry of a step and its
  transport time, and the channel map.
* ``yield_dev``: |observed / expected - 1| for the direct detections of
  the clean photons: those whose reference ray enters a PMT where
  nothing can shade it.  Each contributes its chance of arriving
  unabsorbed and unscattered, of crossing every boundary, and of being
  detected there; the program's count is those it detected directly in
  that channel.  This covers the physics: absorption and scattering
  lengths in the outer medium and the surface's detection table.
* ``yield_crossed_dev``: the same for the photons whose reference ray
  crosses the spherical boundaries (in a vessel) before it enters a PMT
  where nothing can shade it, with the Fresnel transmission of every
  crossing and the attenuation in every medium.  The program's mesh of
  a sphere tilts a crossed ray by about a degree, which moves it across
  a PMT's face, so a detection counts by where it lands: a direct
  detection of a crossed photon counts where it entered its channel's
  PMT where nothing can shade it.  Rays moved in and rays moved out of
  those regions then balance.  This covers the inner media's absorption
  and scattering lengths and the boundaries' Fresnel transmission.
* ``daq_bad``: the share of the sampled events' channels whose readout
  disagrees with the event's own detected photons: hit or not, the
  earliest time within the time spread's bounds, the charge within the
  charge distribution's, and the history word their OR.
"""
import math

import numpy as np
import torch

from portbench.reference import optics

CHUNK = 1 << 18
# A direct photon that crossed a spherical boundary crossed the program's
# mesh of it, whose facets tilt the refracted ray by up to about a degree
# against the analytic sphere (a UV sphere of 48 x 47 cells): its ray
# may stray by this share of the path after the last crossing, and its
# time by CROSSED_TIME_TOL_NS.
CROSSED_OFFSET_SHARE = 0.05
CROSSED_TIME_TOL_NS = 0.05


def _t(x, device):
    return torch.as_tensor(np.ascontiguousarray(x), device=device) \
        .to(torch.float64)


def _candidates(ref, o, d, k=4):
    """The ``k`` PMTs whose centers lie nearest where each ray crosses
    the configuration's search sphere."""
    t = optics.sphere_exit(o, d, ref.search_radius)
    p = optics.normalize(o + t[..., None] * d).to(torch.float32)
    c = optics.normalize(ref.centers).to(torch.float32)
    return torch.topk(p @ c.T, k, dim=1).indices


def expected_direct(ref, pos, d, pol, lam):
    """For emitted photons: (clean, pmt, p, crossed, p_crossed) -
    whether each is clean, the PMT its ray enters first, its chance of a
    direct detection there, whether its ray crosses a boundary, and that
    chance for the crossed rays that enter a PMT where nothing can shade
    them."""
    tr = ref.media.trace(pos, d, pol, lam)
    o, df = tr['origin'], tr['dir']
    cand = _candidates(ref, o, df)
    best_t = torch.full_like(lam, math.inf)
    best_j = torch.full(lam.shape, -1, dtype=torch.int64, device=lam.device)
    best_clean = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    best_p = torch.zeros_like(lam)
    for i in range(cand.shape[1]):
        j = cand[:, i]
        t, clean, p = ref.entry(o - ref.centers[j], df, ref.axes[j], pol,
                                lam)
        take = torch.isfinite(t) & (t < best_t)
        best_t = torch.where(take, t, best_t)
        best_j = torch.where(take, j, best_j)
        best_clean = torch.where(take, clean, best_clean)
        best_p = torch.where(take, p, best_p)
    mu = ref.media.outer.attenuation(lam)
    att = tr['att'] + torch.where(torch.isfinite(best_t), best_t, 0.0) * mu
    # only rays that cross no mesh of a sphere: the facets move a crossed
    # ray across a PMT's face, in and out of the clean region
    crossed = tr['crossings'] > 0
    clean = best_clean & ~crossed & (tr['region'] == 0)
    clean_x = best_clean & crossed & (tr['region'] == 0)
    p = torch.exp(-att) * best_p
    return clean, best_j, torch.where(clean, p, 0.0), crossed, \
        torch.where(clean_x, p * tr['trans'], 0.0)


def check_hits(ref, emitted, hits, device):
    """(bad, total, direct, obs, exp, obs_x, exp_x, why) for one event:
    the direct detections of clean photons observed and expected, those
    of crossed ones, and the reasons of the bad hits.  ``emitted`` the
    bank's photons of the event, ``hits`` its detected photons as the
    program gave them (pos, dir, wavelengths, t, flags, channel)."""
    lam_e = emitted['wavelengths']
    order = np.argsort(lam_e, kind='stable')
    lam_sorted = lam_e[order]
    lam_h = np.asarray(hits['wavelengths'], dtype=np.float32)
    at = np.clip(np.searchsorted(lam_sorted, lam_h), 0, len(lam_sorted) - 1)
    matched = lam_sorted[at] == lam_h
    src = order[at]

    npmt = ref.centers.shape[0]
    ch = np.asarray(hits['channel']).astype(np.int64)
    valid = (ch >= 0) & (ch < npmt)
    chc = np.where(valid, ch, 0)
    flags = np.asarray(hits['flags']).astype(np.int64)
    direct = (flags & optics.INDIRECT) == 0
    n_hits = len(lam_h)

    bad = np.zeros(n_hits, dtype=bool)
    lands_clean = np.zeros(n_hits, dtype=bool)
    why = {k: 0 for k in ('surface', 'too_early', 'off_ray', 'ray_time')}
    for a in range(0, n_hits, CHUNK):
        sl = slice(a, a + CHUNK)
        s = src[sl]
        hp = _t(hits['pos'][sl], device)
        th = _t(hits['t'][sl], device)
        lam = _t(lam_h[sl], device)
        p0 = _t(emitted['pos'][s], device)
        d0 = optics.normalize(_t(emitted['dir'][s], device))
        pol0 = _t(emitted['pol'][s], device)
        t0 = _t(emitted['t'][s], device)
        j = torch.as_tensor(chc[sl], device=device)
        res = ref.surface_residual(hp - ref.centers[j], ref.axes[j])
        lands_clean[sl] = ref.clean_hit(
            hp - ref.centers[j], optics.normalize(_t(hits['dir'][sl],
                                                     device)),
            ref.axes[j]).cpu().numpy()
        fast = t0 + torch.linalg.norm(hp - p0, dim=-1) \
            * ref.media.n_min(lam) / optics.C_MM_PER_NS
        on_surface = res <= ref.surface_tol_mm
        causal = th >= fast - ref.time_tol_ns
        ok = on_surface & causal
        tr = ref.media.trace(p0, d0, pol0, lam)
        v = hp - tr['origin']
        along = optics.dot(v, tr['dir'])
        offset = torch.linalg.norm(v - along[..., None] * tr['dir'], dim=-1)
        t_ref = t0 + tr['time'] + along * ref.media.outer.n(lam) \
            / optics.C_MM_PER_NS
        crossed = tr['crossings'] > 0
        on_ray = (along > 0) & (tr['region'] == 0) & (
            offset <= ref.offset_tol_mm
            + torch.where(crossed, CROSSED_OFFSET_SHARE * along, 0.0))
        in_time = (th - t_ref).abs() <= torch.where(
            crossed, CROSSED_TIME_TOL_NS, ref.time_tol_ns)
        dr = torch.as_tensor(direct[sl], device=device)
        ok = ok & (~dr | (on_ray & in_time))
        bad[sl] = ~ok.cpu().numpy()
        for k, m in (('surface', ~on_surface), ('too_early', ~causal),
                     ('off_ray', dr & ~on_ray), ('ray_time', dr & ~in_time)):
            why[k] += int(m.sum())
    bad |= ~matched | ~valid
    why.update(unmatched=int((~matched).sum()),
               bad_channel=int((~valid).sum()))

    exp = exp_x = 0.0
    clean_pmt = np.full(len(lam_e), -1, dtype=np.int64)
    crossed = np.zeros(len(lam_e), dtype=bool)
    for a in range(0, len(lam_e), CHUNK):
        sl = slice(a, a + CHUNK)
        clean, pmt, p, cr, p_x = expected_direct(
            ref, _t(emitted['pos'][sl], device),
            optics.normalize(_t(emitted['dir'][sl], device)),
            _t(emitted['pol'][sl], device), _t(lam_e[sl], device))
        exp += float(p.sum())
        exp_x += float(p_x.sum())
        clean_pmt[sl] = torch.where(clean, pmt, -1).cpu().numpy()
        crossed[sl] = cr.cpu().numpy()
    good = matched & valid & direct
    obs = int((good & (clean_pmt[src] >= 0) & (clean_pmt[src] == ch)).sum())
    obs_x = int((good & crossed[src] & lands_clean).sum())
    return int(bad.sum()), n_hits, int(direct.sum()), obs, exp, obs_x, \
        exp_x, why


def check_daq(ref, hits, channels):
    """(bad, total) channels of one event's readout."""
    npmt = ref.centers.shape[0]
    ch = np.asarray(hits['channel']).astype(np.int64)
    keep = (ch >= 0) & (ch < npmt)
    ch = ch[keep]
    t = np.asarray(hits['t'], dtype=np.float64)[keep]
    fl = np.asarray(hits['flags']).astype(np.int64)[keep]
    n = np.bincount(ch, minlength=npmt)
    tmin = np.full(npmt, np.inf)
    np.minimum.at(tmin, ch, t)
    orf = np.zeros(npmt, dtype=np.int64)
    np.bitwise_or.at(orf, ch, fl)

    hit = np.asarray(channels['hit'], dtype=bool)
    ct = np.asarray(channels['t'], dtype=np.float64)
    cq = np.asarray(channels['q'], dtype=np.float64)
    cf = np.asarray(channels['flags']).astype(np.int64) & 0xFFFFFFFF
    if len(hit) != npmt:
        return npmt, npmt
    td, qd = ref.time_dist, ref.charge_dist
    lo, hi = (td['lo_ns'], td['hi_ns']) if td['kind'] == 'gaussian' \
        else (0.0, 0.0)
    tol = 1e-3
    has = n > 0
    ok = hit == has
    t_ok = (ct >= tmin + lo - tol) & (ct <= tmin + hi + tol)
    unit = 2.0 ** -16
    if qd['kind'] == 'gaussian':
        q_ok = (cq >= n * qd['lo'] - n * unit - tol) \
            & (cq <= n * qd['hi'] + n * unit + tol) \
            & (np.abs(cq - n * qd['mean'])
               <= 6.0 * qd['rms'] * np.sqrt(n) + n * unit + tol)
    else:
        q_ok = np.abs(cq - n) <= n * unit + tol
    ok &= np.where(has, t_ok & q_ok & (cf == orf),
                   (ct >= 1e8) & (cq == 0))
    return int((~ok).sum()), npmt


def compare(ref, samples, device):
    """Readings of the four numbers over ``samples``: (emitted, hits,
    channels) triples, each a dict of numpy arrays."""
    bad = total = direct = obs = obs_x = 0
    exp = exp_x = 0.0
    daq_bad = daq_total = 0
    why = {}
    for emitted, hits, channels in samples:
        b, n, dr, o, e, ox, ex, w = check_hits(ref, emitted, hits, device)
        for k, v in w.items():
            why[k] = why.get(k, 0) + v
        bad += b
        total += n
        direct += dr
        obs += o
        exp += e
        obs_x += ox
        exp_x += ex
        db, dt = check_daq(ref, hits, channels)
        daq_bad += db
        daq_total += dt
    return dict(
        hits_bad=bad / total if total else 0.0,
        yield_dev=abs(obs / exp - 1.0) if exp > 0 else 1.0,
        yield_crossed_dev=abs(obs_x / exp_x - 1.0) if exp_x > 0 else 1.0,
        daq_bad=daq_bad / daq_total if daq_total else 1.0,
        counts=dict(hits=total, direct=direct, clean_observed=obs,
                    clean_expected=exp, crossed_observed=obs_x,
                    crossed_expected=exp_x, channels=daq_total,
                    failed=why))

"""Source kind ``muon_chord``: through-going cosmic muons.

Event k of a bank of K crosses the configuration's fiducial sphere
(radius R, ``fiducial_radius_mm``) at the impact parameter
b_k = R sqrt((k + 1/2) / K), so every seed has the same chord lengths
(their density grows with the length, as an isotropic flux's does); the
seed draws each chord's direction (zenith cos^2, from above) and where
around the axis it passes.  Its photons start uniform along the chord at
t = s / (beta c), on the Cherenkov cone cos(theta) = 1 / (beta n),
polarized in the plane of track and photon, with the Frank-Tamm yield
2 pi alpha (1 - 1 / (beta n)^2) (1 / lambda1 - 1 / lambda2) per unit
length (PDG Review, "Passage of particles through matter").

Wavelengths follow the 1 / lambda^2 spectrum at the quantiles
(i + 1/2) / N of an event, dealt to its photons in an order drawn from
the seed.  So every event's wavelengths are distinct float32 values, and
the check can tell which emitted photon a detected one was: propagation
in these detectors never changes a wavelength.

Parameters (the traffic file's ``source``): ``bank_events``, ``beta``,
``refractive_index``, ``wavelength_nm`` [lambda1, lambda2].
"""
import math

import numpy as np
import torch

C_MM_PER_NS = 299.792458
FINE_STRUCTURE = 1.0 / 137.035999


def frank_tamm_per_mm(beta, n, lam1_nm, lam2_nm):
    """Cherenkov photons per mm of track between two wavelengths."""
    per_nm = 2 * math.pi * FINE_STRUCTURE * (1 - 1 / (beta * n) ** 2) \
        * (1 / lam1_nm - 1 / lam2_nm)
    return per_nm * 1e6


def chord_lengths(radius, k_events):
    """The bank's fixed chord lengths (mm) and impact parameters."""
    k = np.arange(k_events, dtype=np.float64)
    b = radius * np.sqrt((k + 0.5) / k_events)
    return 2.0 * np.sqrt(radius ** 2 - b ** 2), b


def _basis(d):
    """Two unit vectors completing ``d`` (N, 3) to a right-handed frame."""
    helper = torch.zeros_like(d)
    helper[:, 0] = 1.0
    helper = torch.where((d[:, :1].abs() > 0.9), torch.roll(helper, 1, 1),
                         helper)
    e1 = torch.linalg.cross(d, helper)
    e1 = e1 / torch.linalg.norm(e1, dim=1, keepdim=True)
    return e1, torch.linalg.cross(d, e1)


def _wavelengths(ev, counts, key, src):
    """Stratified wavelengths, dealt within each event in the order of
    ``key``."""
    order = torch.argsort(ev.to(torch.float64) * 2.0 + key)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(len(ev), device=ev.device) - starts[ev[order]]
    F = (rank.to(torch.float64) + 0.5) / counts[ev[order]]
    lam1, lam2 = src['wavelength_nm']
    lam = torch.empty_like(key)
    lam[order] = 1.0 / (1.0 / lam1 - F * (1.0 / lam1 - 1.0 / lam2))
    return lam


def make_bank(source, cfg, seed, device):
    """The input bank: dict of float32 numpy arrays ``pos``, ``dir``,
    ``pol``, ``wavelengths``, ``t`` over all events, ``offsets`` (K + 1)
    and per-event ``meta``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)
    fiducial_radius = cfg['fiducial_radius_mm']
    K = int(source['bank_events'])
    beta, n = source['beta'], source['refractive_index']
    per_mm = frank_tamm_per_mm(beta, n, *source['wavelength_nm'])
    L_np, b_np = chord_lengths(fiducial_radius, K)
    counts = torch.as_tensor(np.rint(per_mm * L_np).astype(np.int64),
                             device=device)
    u = torch.rand((K, 3), generator=g, **f64)
    cz = u[:, 0] ** (1.0 / 3.0)          # zenith cos^2, from above
    phi = 2 * math.pi * u[:, 1]
    sz = torch.sqrt(1.0 - cz * cz)
    d = torch.stack([sz * torch.cos(phi), sz * torch.sin(phi), -cz], 1)
    e1, e2 = _basis(d)
    psi = (2 * math.pi * u[:, 2])[:, None]
    b = torch.as_tensor(b_np, **f64)[:, None]
    L = torch.as_tensor(L_np, **f64)
    entry = b * (torch.cos(psi) * e1 + torch.sin(psi) * e2) \
        - (L / 2.0)[:, None] * d
    ev = torch.repeat_interleave(torch.arange(K, device=device), counts)
    v = torch.rand((len(ev), 3), generator=g, **f64)
    s = v[:, 0] * L[ev]
    pos = entry[ev] + s[:, None] * d[ev]
    t = s / (beta * C_MM_PER_NS)
    cos_c = 1.0 / (beta * n)
    sin_c = math.sqrt(1.0 - cos_c * cos_c)
    alpha = (2 * math.pi * v[:, 1])[:, None]
    dirs = cos_c * d[ev] + sin_c * (torch.cos(alpha) * e1[ev]
                                    + torch.sin(alpha) * e2[ev])
    pol = (d[ev] - cos_c * dirs) / sin_c
    lam = _wavelengths(ev, counts, v[:, 2], source)
    meta = dict(entry=entry.cpu().numpy(), direction=d.cpu().numpy(),
                length=L_np, impact=b_np)
    offsets = np.concatenate([[0], np.cumsum(counts.cpu().numpy())])
    lam = lam.to(torch.float32)
    _check_distinct(ev, lam)

    def f32(x):
        return x.to(torch.float32).cpu().numpy()
    return dict(pos=f32(pos), dir=f32(dirs), pol=f32(pol),
                wavelengths=f32(lam), t=f32(t), offsets=offsets, meta=meta)


def _check_distinct(ev, lam):
    """Every event's wavelengths must be distinct float32 values."""
    key = torch.sort(ev.to(torch.float64) * 1e4 + lam.to(torch.float64))[0]
    if len(key) > 1 and not bool((key[1:] > key[:-1]).all()):
        raise RuntimeError('an event of the bank repeats a wavelength')

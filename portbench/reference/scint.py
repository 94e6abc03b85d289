"""A plain liquid scintillator for the correctness check, in float64
torch: its tables, its emission spectrum and a Monte Carlo of bulk
reemission.

Nothing here imports the program.  The tables are the configuration's
``scintillator`` entry, linear between its wavelength nodes and held at
the end values outside them.  Chroma's semantics hold: a photon in the
scintillator meets absorption (the total absorption length) and
Rayleigh scattering at exponential distances; an absorption picks
component c with probability (1 / L_c) / (1 / L), taken cumulatively
against one uniform, the last component taking what is left, and is
reemitted with that component's probability, isotropically, at a
wavelength drawn from the emission spectrum (its CDF linear between the
nodes, the trapezoid rule at them).
"""
import math

import numpy as np
import torch

from portbench.reference import check, optics

CHUNK = 1 << 17


class Spectrum(object):
    """The emission spectrum: a density per nm at the nodes, its CDF by
    the trapezoid rule at the nodes and linear between them."""

    def __init__(self, wavelengths, density, lo=None, hi=None):
        lam = np.asarray(wavelengths, dtype=np.float64)
        y = np.asarray(density, dtype=np.float64)
        keep = np.ones(len(lam), dtype=bool)
        if lo is not None:
            keep &= lam >= lo
        if hi is not None:
            keep &= lam <= hi
        lam, y = lam[keep], y[keep]
        cdf = np.concatenate([[0.0], np.cumsum(
            0.5 * (y[1:] + y[:-1]) * np.diff(lam))])
        cdf /= cdf[-1]
        # the support: from the last node the CDF is 0 at to the first
        # node it is 1 at
        first = np.flatnonzero(cdf > 0)[0] - 1
        last = np.flatnonzero(cdf < 1)[-1] + 1
        self.x = lam[first:last + 1]
        self.cdf = cdf[first:last + 1]
        if not (np.diff(self.cdf) > 0).all():
            raise ValueError('the spectrum vanishes inside its support')
        self.lo, self.hi = float(self.x[0]), float(self.x[-1])

    def quantile(self, F):
        """Wavelengths (nm) at the CDF values ``F`` in [0, 1]."""
        x = torch.as_tensor(self.x, dtype=torch.float64, device=F.device)
        c = torch.as_tensor(self.cdf, dtype=torch.float64, device=F.device)
        F = F.to(torch.float64)
        j = torch.searchsorted(c, F, right=True).clamp(1, len(c) - 1)
        f = (F - c[j - 1]) / (c[j] - c[j - 1])
        return x[j - 1] + f * (x[j] - x[j - 1])


class Scintillator(object):
    """The configuration's ``scintillator``: its medium for
    ``optics.Media``, components and emission spectrum."""

    def __init__(self, scint):
        lam = scint['wavelength_nm']
        self.components = [optics.Table(lam, c)
                           for c in scint['abslength_mm']]
        self.reemission_prob = [float(p) for p in scint['reemission_prob']]
        comp = np.asarray(scint['abslength_mm'], dtype=np.float64)
        self.absorption = optics.Table(lam, 1.0 / (1.0 / comp).sum(0))
        self.scattering = optics.Table(lam, scint['rslength_mm'])
        self.medium = optics.Medium(
            'scintillator', optics.Table(lam, [scint['rindex']] * len(lam)),
            self.absorption, self.scattering)
        self.spectrum = Spectrum(lam, scint['emission'])

    def component(self, lam, u):
        """The absorbing component of photons at ``lam`` against the
        uniforms ``u``."""
        total = self.absorption(lam)
        cum = torch.zeros_like(lam)
        pick = torch.full(lam.shape, len(self.components) - 1,
                          dtype=torch.int64, device=lam.device)
        chosen = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
        for c, table in enumerate(self.components[:-1]):
            cum = cum + total / table(lam)
            take = ~chosen & (u < cum)
            pick = torch.where(take, c, pick)
            chosen |= take
        return pick

    def reemission(self, lam, comp):
        """The reemission probability of absorbed photons."""
        p = torch.as_tensor(self.reemission_prob, dtype=torch.float64,
                            device=lam.device)
        return p[comp]


def isotropic(u1, u2):
    """Unit vectors uniform on the sphere from two uniforms."""
    cz = 2.0 * u1 - 1.0
    sz = torch.sqrt(torch.clamp(1.0 - cz * cz, min=0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([sz * torch.cos(phi), sz * torch.sin(phi), cz], -1)


def transverse(d, u1, u2):
    """A unit vector normal to ``d``, uniform around it."""
    p = torch.linalg.cross(isotropic(u1, u2), d)
    return optics.normalize(p)


def expected_reemitted(ref, pos, d, lam, radius, draws, generator,
                       generations=16):
    """Expected clean direct detections of reemitted photons for photons
    starting at ``pos`` along ``d`` at ``lam`` inside the scintillator
    sphere of ``radius``: ``draws`` chains a photon, each followed while
    it is absorbed and reemitted inside the sphere.  Each generation
    draws its interaction point on its straight ray (absorption plus
    scattering) or leaves the sphere; a scatter ends the chain; an
    absorption reemits as ``Scintillator`` says; every reemitted photon
    adds ``check.expected_direct``'s chance of a clean direct detection
    after crossing the vessel.  Returns (expected, reemitted photons per
    photon, generations per reemitted photon)."""
    scint = ref.scint
    f64 = dict(dtype=torch.float64, device=pos.device)
    expected = reemitted = generated = 0.0
    step = max(1, CHUNK // draws)
    for a in range(0, len(lam), step):
        p = pos[a:a + step].repeat_interleave(draws, 0)
        v = d[a:a + step].repeat_interleave(draws, 0)
        w = lam[a:a + step].repeat_interleave(draws, 0)
        ever = torch.zeros(len(w), dtype=torch.bool, device=w.device)
        ids = torch.arange(len(w), device=w.device)
        for _ in range(generations):
            if len(w) == 0:
                break
            u = torch.rand((len(w), 9), generator=generator, **f64)
            mu_a = 1.0 / scint.absorption(w)
            mu = mu_a + 1.0 / scint.scattering(w)
            s = -torch.log(u[:, 0]) / mu
            inside = s < optics.sphere_exit(p, v, radius)
            absorbed = inside & (u[:, 1] * mu < mu_a)
            comp = scint.component(w, u[:, 2])
            again = absorbed & (u[:, 3] < scint.reemission(w, comp))
            p = (p + s[:, None] * v)[again]
            v = isotropic(u[again, 4], u[again, 5])
            pol = transverse(v, u[again, 6], u[again, 7])
            w = scint.spectrum.quantile(u[again, 8])
            ids = ids[again]
            ever[ids] = True
            generated += len(w)
            for b in range(0, len(w), CHUNK):
                sl = slice(b, b + CHUNK)
                expected += float(check.expected_direct(
                    ref, p[sl], v[sl], pol[sl], w[sl])[4].sum())
        reemitted += float(ever.sum())
    n = len(lam) * draws
    return expected / draws, reemitted / n if n else 0.0, \
        generated / reemitted if reemitted else 0.0

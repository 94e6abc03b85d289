"""Plain geometric optics for the correctness check, in float64 torch.

Nothing here imports the program.  It knows a detector only through
what a configuration's own file states: its media as tables against
wavelength, concentric spherical boundaries between them, and where
its PMTs sit.  Chroma's semantics hold throughout: a photon moves in
straight lines at the phase velocity c / n; at a boundary without a
surface it is refracted or reflected by the polarization-resolved
Fresnel equations (reflection marks it REFLECT_SPECULAR); bulk
absorption and Rayleigh scattering end or deflect it with the
probabilities exp(-L / length).
"""
import math

import numpy as np
import torch

C_MM_PER_NS = 299.792458
HC_MEV_NM = 2 * math.pi * 197.3269804e-6  # 2 pi hbar c, MeV nm

# photon history bits (chroma/cuda/photon.h; the on-disk ABI)
RAYLEIGH_SCATTER = 1 << 4
REFLECT_DIFFUSE = 1 << 5
REFLECT_SPECULAR = 1 << 6
SURFACE_REEMIT = 1 << 7
SURFACE_TRANSMIT = 1 << 8
BULK_REEMIT = 1 << 9
# a detected photon carrying none of these went straight from its
# start, refracted only
INDIRECT = (RAYLEIGH_SCATTER | REFLECT_DIFFUSE | REFLECT_SPECULAR
            | SURFACE_REEMIT | SURFACE_TRANSMIT | BULK_REEMIT)


class Table(object):
    """A property against wavelength (nm): linear between the nodes,
    held at the end values outside them (numpy's ``interp``)."""

    def __init__(self, wavelengths, values):
        order = np.argsort(wavelengths)
        self.x = np.asarray(wavelengths, dtype=np.float64)[order]
        self.y = np.asarray(values, dtype=np.float64)[order]

    def __call__(self, lam):
        x = torch.as_tensor(self.x, dtype=torch.float64, device=lam.device)
        y = torch.as_tensor(self.y, dtype=torch.float64, device=lam.device)
        lam = lam.to(torch.float64).clamp(x[0], x[-1])
        j = torch.searchsorted(x, lam, right=True).clamp(1, len(x) - 1)
        x0, x1 = x[j - 1], x[j]
        f = (lam - x0) / (x1 - x0)
        return y[j - 1] + f * (y[j] - y[j - 1])


def energy_table(energies_mev, values):
    """A table given against photon energy (MeV), as GDML gives it."""
    return Table(HC_MEV_NM / np.asarray(energies_mev, dtype=np.float64),
                 values)


class Medium(object):
    """A bulk medium: refractive index, absorption and scattering
    lengths (mm); ``scattering`` None means none."""

    def __init__(self, name, n, absorption, scattering=None):
        self.name = name
        self.n = n
        self.absorption = absorption
        self.scattering = scattering

    def attenuation(self, lam):
        """1 / absorption length + 1 / scattering length (1/mm)."""
        mu = 1.0 / self.absorption(lam)
        if self.scattering is not None:
            mu = mu + 1.0 / self.scattering(lam)
        return mu


def dot(a, b):
    return (a * b).sum(-1)


def normalize(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def fresnel_transmission(cos_i, n1, n2):
    """(T_s, T_p, cos_t, tir): intensity transmission of s- and
    p-polarized light from index n1 into n2 at incidence cos_i."""
    eta = n1 / n2
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    rs = (n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t)
    rp = (n2 * cos_i - n1 * cos_t) / (n2 * cos_i + n1 * cos_t)
    ts = torch.where(tir, 0.0, 1.0 - rs * rs)
    tp = torch.where(tir, 0.0, 1.0 - rp * rp)
    return ts, tp, cos_t, tir


def s_fraction(d, normal, pol):
    """Share of the photon's polarization normal to the plane of
    incidence; at normal incidence the two branches agree."""
    s = torch.cross(d, normal, dim=-1)
    length = torch.linalg.norm(s, dim=-1, keepdim=True)
    s = torch.where(length > 1e-9, s / length.clamp(min=1e-300), pol)
    return dot(pol, s) ** 2


def refract(d, normal, eta, cos_i, cos_t):
    """Snell's law in vector form; ``normal`` points against ``d``."""
    return eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * normal


def sphere_exit(o, d, radius):
    """Distance along ``d`` from ``o`` (inside) to the sphere of
    ``radius`` about the origin."""
    b = dot(o, d)
    c = dot(o, o) - radius * radius
    return -b + torch.sqrt(torch.clamp(b * b - c, min=0.0))


def _sphere_hits(o, d, radius):
    """The two distances (near, far) at which the ray meets the sphere,
    inf where it misses."""
    b = dot(o, d)
    c = dot(o, o) - radius * radius
    disc = b * b - c
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    miss = disc < 0
    near = torch.where(miss, math.inf, -b - root)
    far = torch.where(miss, math.inf, -b + root)
    return near, far


class Media(object):
    """Concentric spherical media about the origin.  ``outer`` fills
    everything outside the spheres; ``spheres`` are (radius, medium)
    pairs, the medium filling the sphere down to the next smaller one."""

    def __init__(self, outer, spheres=()):
        self.outer = outer
        self.spheres = sorted(spheres, key=lambda s: -s[0])
        self.media = [outer] + [m for _, m in self.spheres]
        self.radii = [r for r, _ in self.spheres]

    def region(self, pos):
        """Index into ``media`` of the region each point lies in."""
        r = torch.linalg.norm(pos, dim=-1)
        idx = torch.zeros(r.shape, dtype=torch.int64, device=r.device)
        for k, radius in enumerate(self.radii):
            idx = torch.where(r < radius, k + 1, idx)
        return idx

    def n_min(self, lam):
        return torch.stack([m.n(lam) for m in self.media]).min(0).values

    def _index(self, region, lam):
        ns = torch.stack([m.n(lam) for m in self.media])
        return ns.gather(0, region[None]).squeeze(0)

    def _mu(self, region, lam):
        mus = torch.stack([m.attenuation(lam) for m in self.media])
        return mus.gather(0, region[None]).squeeze(0)

    def trace(self, pos, d, pol, lam, max_crossings=6):
        """Follow straight rays refracted at every spherical boundary
        until they are in the outer medium heading out of every sphere.

        Returns dict: ``origin``, ``dir`` of the last segment, ``time``
        (ns) and ``att`` (the optical depth sum L / length) up to
        ``origin``, ``trans`` the Fresnel transmission of all crossings
        (the polarization branch of the first crossing kept after it,
        as the program keeps a pure s or p state; 0 where a crossing
        would reflect totally), ``crossings`` and ``region``, where the
        last segment runs."""
        o = pos.to(torch.float64)
        d = normalize(d.to(torch.float64))
        pol = pol.to(torch.float64)
        lam = lam.to(torch.float64)
        region = self.region(o)
        time = torch.zeros_like(lam)
        att = torch.zeros_like(lam)
        ts_prod = torch.ones_like(lam)
        tp_prod = torch.ones_like(lam)
        s_frac = torch.ones_like(lam)
        crossings = torch.zeros_like(region)
        eps = 1e-6
        for _ in range(max_crossings):
            best = torch.full_like(lam, math.inf)
            nxt = region.clone()
            for k, radius in enumerate(self.radii):
                near, far = _sphere_hits(o, d, radius)
                near = torch.where(near > eps, near, math.inf)
                far = torch.where(far > eps, far, math.inf)
                # entering sphere k from outside, or leaving it
                t_in = torch.where(region <= k, near, math.inf)
                t_out = torch.where(region == k + 1, far, math.inf)
                take_in = t_in < best
                best = torch.where(take_in, t_in, best)
                nxt = torch.where(take_in, k + 1, nxt)
                take_out = t_out < best
                best = torch.where(take_out, t_out, best)
                nxt = torch.where(take_out, k, nxt)
            go = torch.isfinite(best)
            if not bool(go.any()):
                break
            step = torch.where(go, best, 0.0)
            n1 = self._index(region, lam)
            n2 = self._index(nxt, lam)
            time = time + step * n1 / C_MM_PER_NS
            att = att + step * self._mu(region, lam)
            p = o + step[..., None] * d
            normal = normalize(p)
            normal = torch.where((dot(normal, d) > 0)[..., None],
                                 -normal, normal)
            cos_i = -dot(normal, d)
            ts, tp, cos_t, t_ir = fresnel_transmission(cos_i, n1, n2)
            first = go & (crossings == 0)
            s_frac = torch.where(first, s_fraction(d, normal, pol), s_frac)
            ts_prod = torch.where(go, ts_prod * ts, ts_prod)
            tp_prod = torch.where(go, tp_prod * tp, tp_prod)
            new_d = normalize(refract(d, normal, n1 / n2, cos_i, cos_t))
            o = torch.where(go[..., None], p, o)
            d = torch.where((go & ~t_ir)[..., None], new_d, d)
            region = torch.where(go, nxt, region)
            crossings = crossings + go.to(crossings.dtype)
        trans = torch.where(crossings > 0,
                            s_frac * ts_prod + (1.0 - s_frac) * tp_prod,
                            torch.ones_like(lam))
        return dict(origin=o, dir=d, time=time, att=att, trans=trans,
                    crossings=crossings, region=region)


def local_axial(q, a):
    """(axial coordinate, squared radial distance) of points ``q``
    relative to an axis ``a`` through the origin."""
    y = dot(q, a)
    r2 = torch.clamp(dot(q, q) - y * y, min=0.0)
    return y, r2


def ray_revolution_quadratic(q, d, a, ka, kb, kc):
    """Roots of r(t)^2 = ka + kb y(t) + kc y(t)^2 for the ray q + t d
    about axis ``a``: cones, cylinders and (kc < 0) spheroids.  Returns
    (near, far), nan where it misses."""
    ya = dot(q, a)
    da = dot(d, a)
    qq = dot(q, q)
    qd = dot(q, d)
    # r^2(t) = qq + 2 t qd + t^2 - (ya + t da)^2
    A = 1.0 - da * da - kc * da * da
    B = 2.0 * (qd - ya * da) - kb * da - 2.0 * kc * ya * da
    C = qq - ya * ya - ka - kb * ya - kc * ya * ya
    disc = B * B - 4.0 * A * C
    ok = (disc >= 0) & (A.abs() > 1e-12)
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-B - root) / (2.0 * A)
    t2 = (-B + root) / (2.0 * A)
    near = torch.where(ok, torch.minimum(t1, t2), math.nan)
    far = torch.where(ok, torch.maximum(t1, t2), math.nan)
    return near, far

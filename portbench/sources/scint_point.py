"""Source kind ``scint_point``: point events in a liquid scintillator,
as a double-beta or background event of a few MeV gives.

Event k of a bank of K has a vertex uniform in the sphere of
``vertex_radius_mm`` and a time uniform in [0, 100) ns, both from the
seed, and Poisson(``light_yield_per_mev`` x ``energy_mev``) photons:
isotropic, polarized at random across their direction, emitted at the
vertex time plus a delay from the configuration's scintillation time
profile (``scintillator.time_profile``: exponentials of ``tau_ns`` with
their ``weight``).

Wavelengths follow the configuration's emission spectrum
(``scintillator.emission``, cut to ``wavelength_nm``) at the quantiles
(i + 1/2) / N of an event, dealt to its photons in an order drawn from
the seed.  So every event's wavelengths are distinct float32 values, and
the check can tell which emitted photon a detected one was, unless it
was reemitted, which draws a new wavelength.

Parameters (the traffic file's ``source``): ``bank_events``,
``energy_mev``, ``light_yield_per_mev``, ``vertex_radius_mm``,
``wavelength_nm`` [lambda1, lambda2].
"""
import numpy as np
import torch

from portbench.reference.scint import Spectrum, isotropic, transverse
from portbench.sources.muon_chord import _check_distinct

VERTEX_TIME_NS = 100.0


def _wavelengths(ev, counts, key, spectrum):
    """Stratified wavelengths, dealt within each event in the order of
    ``key``."""
    order = torch.argsort(ev.to(torch.float64) * 2.0 + key)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(len(ev), device=ev.device) - starts[ev[order]]
    F = (rank.to(torch.float64) + 0.5) / counts[ev[order]]
    lam = torch.empty_like(key)
    lam[order] = spectrum.quantile(F)
    return lam


def _delays(u_comp, u_time, profile):
    """Delays (ns) from a sum of exponentials: a component by weight,
    then its exponential."""
    tau = torch.as_tensor(profile['tau_ns'], dtype=torch.float64,
                          device=u_comp.device)
    w = torch.as_tensor(profile['weight'], dtype=torch.float64,
                        device=u_comp.device)
    cum = torch.cumsum(w / w.sum(), 0)
    comp = torch.searchsorted(cum, u_comp.contiguous(), right=True) \
        .clamp(max=len(tau) - 1)
    return -tau[comp] * torch.log1p(-u_time)


def make_bank(source, cfg, seed, device):
    """The input bank: dict of float32 numpy arrays ``pos``, ``dir``,
    ``pol``, ``wavelengths``, ``t`` over all events, ``offsets`` (K + 1)
    and per-event ``meta`` (``vertex``, ``time``)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)
    scint = cfg['scintillator']
    spectrum = Spectrum(scint['wavelength_nm'], scint['emission'],
                        *source['wavelength_nm'])
    K = int(source['bank_events'])
    mean = source['light_yield_per_mev'] * source['energy_mev']
    counts = torch.poisson(torch.full((K,), mean, **f64),
                           generator=g).to(torch.int64)
    u = torch.rand((K, 4), generator=g, **f64)
    r = source['vertex_radius_mm'] * u[:, 0] ** (1.0 / 3.0)
    vertex = r[:, None] * isotropic(u[:, 1], u[:, 2])
    t0 = VERTEX_TIME_NS * u[:, 3]
    ev = torch.repeat_interleave(torch.arange(K, device=device), counts)
    v = torch.rand((len(ev), 7), generator=g, **f64)
    dirs = isotropic(v[:, 0], v[:, 1])
    pol = transverse(dirs, v[:, 2], v[:, 3])
    t = t0[ev] + _delays(v[:, 4], v[:, 5], scint['time_profile'])
    lam = _wavelengths(ev, counts, v[:, 6], spectrum).to(torch.float32)
    _check_distinct(ev, lam)
    offsets = np.concatenate([[0], np.cumsum(counts.cpu().numpy())])
    meta = dict(vertex=vertex.cpu().numpy(), time=t0.cpu().numpy())

    def f32(x):
        return x.to(torch.float32).cpu().numpy()
    pos = f32(vertex)[ev.cpu().numpy()]
    return dict(pos=pos, dir=f32(dirs), pol=f32(pol),
                wavelengths=lam.cpu().numpy(), t=f32(t), offsets=offsets,
                meta=meta)


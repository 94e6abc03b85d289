"""Source kind ``point_bomb_tiny`` (a test's new kind): events of
``photons`` isotropic photons from one point each, drawn uniform inside
``radius_mm``, wavelengths uniform in ``wavelength_nm``, at t = 0."""
import numpy as np
import torch


def make_bank(source, cfg, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)
    K, n = int(source['bank_events']), int(source['photons'])
    u = torch.rand((K, 3), generator=g, **f64)
    cz = 2 * u[:, 0] - 1
    phi = 2 * np.pi * u[:, 1]
    r = source['radius_mm'] * u[:, 2] ** (1.0 / 3.0)
    sz = torch.sqrt(1 - cz * cz)
    centers = r[:, None] * torch.stack([sz * torch.cos(phi),
                                        sz * torch.sin(phi), cz], 1)
    v = torch.rand((K * n, 3), generator=g, **f64)
    cz = 2 * v[:, 0] - 1
    phi = 2 * np.pi * v[:, 1]
    sz = torch.sqrt(1 - cz * cz)
    d = torch.stack([sz * torch.cos(phi), sz * torch.sin(phi), cz], 1)
    helper = torch.zeros_like(d)
    helper[:, 0] = 1.0
    helper = torch.where(d[:, :1].abs() > 0.9, torch.roll(helper, 1, 1),
                         helper)
    pol = torch.linalg.cross(d, helper)
    pol = pol / torch.linalg.norm(pol, dim=1, keepdim=True)
    lam1, lam2 = source['wavelength_nm']
    lam = lam1 + (lam2 - lam1) * v[:, 2]

    def f32(x):
        return x.to(torch.float32).cpu().numpy()
    return dict(pos=f32(centers.repeat_interleave(n, 0)), dir=f32(d),
                pol=f32(pol), wavelengths=f32(lam),
                t=np.zeros(K * n, np.float32),
                offsets=np.arange(K + 1) * n, meta=dict(centers=f32(centers)))

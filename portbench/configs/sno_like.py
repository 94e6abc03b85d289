"""The SNO-like detector: how the program's tables are built and cached,
and the plain reference the check holds its output against.

``load`` writes the detector's GDML and RATDB files into the cache
(``sno_like_gdml.py``), loads them through the program's
``rat.RATGeoLoader``, packs the flat tables once into the table cache
and serves every run from there.  ``FAULTS`` plant a fault in the
loaded tables, for the benchmark's tests of its check.  Everything below
them is the reference, which reads the same constants the files are written from:
the PMTs' placements, their polycone bodies whose whole skin detects
with the table EFF_PMT (a dielectric_metal surface: no refraction), and
the media: light water outside a 6.0 m acrylic orb that holds a
5.945 m orb of heavy water.
"""
import dataclasses
import math
import os

import numpy as np
import torch

from portbench.configs import sno_like_gdml as gdml
from portbench.reference import optics

# check tolerances: the vessel is two orbs of 4,416 facets, whose
# normals lie up to ~4 degrees off the sphere's, which moves a refracted
# ray sideways by up to ~1 mm in the 55 mm wall; the body is revolved
# at 64 steps (0.12% inside the polycone)
OFFSET_TOL_MM = 5.0
TIME_TOL_NS = 0.01
SURFACE_TOL_MM = 1.0
# clean: entering the body's upper cone or top (z >= 25 mm, r <= 80 mm)
# within 20 degrees of the axis, which keeps the ray inside the
# concentrator's mouth (r >= 108 mm) all the way down
CLEAN_MIN_Z_MM = 25.0
CLEAN_MAX_ANGLE_DEG = 20.0


def _sno_classifier(volume_ref, material_ref, parent_material_ref):
    """PMT bodies are channels, the world is omitted, the rest are
    solids (their skin surfaces come from the GDML)."""
    if volume_ref == 'world_log':
        return 'omit', {}
    if volume_ref.startswith('pmt_body_log'):
        return 'pmt', dict(color=0xA0A05000, channel_type=1)
    return 'solid', dict(color=0x33A0A0A0)


def load(cfg, device, cache_dir):
    """The program's GPUDetector from the table cache; on a miss the
    GDML is written, loaded and packed."""
    from chroma_tpu_torch import gpu
    name = cfg['table_cache']
    gg = gpu.GPUDetector.from_table_cache(name, device=device)
    if gg is None:
        from chroma_tpu_torch.detector import Detector
        from chroma_tpu_torch.rat import RATGeoLoader
        path, ratdb = gdml.sno_like_gdml(cfg['npmt'], os.path.join(
            cache_dir, 'sno', 'sno_%d.gdml' % cfg['npmt']))
        loader = RATGeoLoader(path, ratdb_file=ratdb)
        loader.add_pmt_info()
        d2o = loader.materials_used[loader.material_lookup['heavy_water']]
        det = loader.build_detector(detector=Detector(d2o),
                                    volume_classifier=_sno_classifier)
        det.flatten()
        gpu.GPUDetector(det, device).save_table_cache(name)
        del det, loader
        gg = gpu.GPUDetector.from_table_cache(name, device=device)
    if gg.nchannels != cfg['channels']:
        raise RuntimeError('%s has %d channels, not %d'
                           % (name, gg.nchannels, cfg['channels']))
    return gg


def _absorption_cut(table):
    def plant(gg, cfg):
        """The program's tables with the absorption length of the
        medium written from ``table`` cut tenfold, as a slip of units
        would: the medium is the row that matches the table over
        300-600 nm."""
        geom = gg.geom
        lam = geom.wavelength0 + geom.wavelength_step \
            * np.arange(geom.nwavelengths)
        lam = torch.as_tensor(lam[(lam >= 300.0) & (lam <= 600.0)])
        k = ((lam - geom.wavelength0) / geom.wavelength_step).round().long()
        have = geom.absorption_length.cpu().to(torch.float64)[:, k]
        err = (torch.log(have) - torch.log(_table(table)(lam))).abs() \
            .median(dim=1).values
        m = int(err.argmin())
        if float(err[m]) > 0.05:
            raise RuntimeError('no medium of the tables follows %s' % table)
        absorption = geom.absorption_length.clone()
        absorption[m] *= 0.1
        gg.geom = dataclasses.replace(geom, absorption_length=absorption)
        return gg
    return plant


FAULTS = {'d2o_abs': _absorption_cut('ABS_D2O'),
          'acrylic_abs': _absorption_cut('ABS_ACRYLIC')}


# ---- the reference ---------------------------------------------------

def _table(name):
    return optics.energy_table(gdml._ENERGIES, gdml.TABLES[name])


class SNOReference(object):
    """What the check knows of the SNO-like detector."""

    offset_tol_mm = OFFSET_TOL_MM
    time_tol_ns = TIME_TOL_NS
    surface_tol_mm = SURFACE_TOL_MM

    def __init__(self, cfg, device):
        self.device = device
        pos, _ = gdml.sno_pmt_placements(cfg['npmt'])
        # the RAT loader adds the PMTs' physvols from the last to the
        # first: channel k is the PMT written (npmt - 1 - k)th
        pos = pos[::-1].copy()
        self.centers = torch.as_tensor(pos, dtype=torch.float64,
                                       device=device)
        self.axes = -optics.normalize(self.centers)
        self.search_radius = cfg['search_radius_mm']
        water = optics.Medium('water', _table('RI_WATER'),
                              _table('ABS_WATER'), _table('RS_WATER'))
        acrylic = optics.Medium('acrylic', _table('RI_ACRYLIC'),
                                _table('ABS_ACRYLIC'))
        d2o = optics.Medium('heavy_water', _table('RI_WATER'),
                            _table('ABS_D2O'), _table('RS_WATER'))
        r_av = cfg['av_radius_mm']
        self.media = optics.Media(water, [(r_av, acrylic),
                                          (r_av - cfg['av_wall_mm'], d2o)])
        self.eff = _table('EFF_PMT')
        self.z = np.asarray(gdml.SNO_BODY_Z, dtype=np.float64)
        self.r = np.asarray(gdml.SNO_BODY_R, dtype=np.float64)
        self.time_dist = cfg['time_dist']
        self.charge_dist = cfg['charge_dist']

    def _body_hit(self, q, d, a):
        """Distance to the first point of the polycone body on the ray
        q + t d, and that point's axial coordinate (nan on a miss)."""
        best = torch.full(q.shape[:-1], math.inf, dtype=torch.float64,
                          device=q.device)
        ya = optics.dot(q, a)
        da = optics.dot(d, a)
        for i in range(len(self.z) - 1):
            z0, z1, r0, r1 = self.z[i], self.z[i + 1], self.r[i], \
                self.r[i + 1]
            beta = (r1 - r0) / (z1 - z0)
            alpha = r0 - beta * z0
            for t in optics.ray_revolution_quadratic(
                    q, d, a, alpha * alpha, 2 * alpha * beta, beta * beta):
                z = ya + t * da
                ok = (t > 0) & (z >= z0) & (z <= z1)
                best = torch.where(ok & (t < best), t, best)
        for zc, rc in ((self.z[-1], self.r[-1]), (self.z[0], self.r[0])):
            t = (zc - ya) / torch.where(da.abs() > 1e-12, da, 1e-12)
            p = q + t[..., None] * d
            _, r2 = optics.local_axial(p, a)
            ok = (t > 0) & (r2 <= rc * rc)
            best = torch.where(ok & (t < best), t, best)
        t = torch.where(torch.isfinite(best), best, math.nan)
        z = ya + t * da
        return t, z

    def entry(self, q, d, a, pol, lam):
        """(t, clean, p_detect) of the ray q + t d against the PMT of
        axis ``a`` (q relative to its center): the distance to its body,
        whether the photon is clean, and the chance that a photon
        arriving there is detected: EFF_PMT at its wavelength."""
        t, z = self._body_hit(q, d, a)
        clean = torch.isfinite(t) & (z >= CLEAN_MIN_Z_MM) \
            & (-optics.dot(d, a) >= math.cos(math.radians(
                CLEAN_MAX_ANGLE_DEG)))
        return t, clean, self.eff(lam)

    def clean_hit(self, q, d, a):
        """Whether a photon detected at ``q`` (relative to its PMT's
        center) moving along ``d`` entered where ``entry`` calls clean."""
        z, _ = optics.local_axial(q, a)
        return (z >= CLEAN_MIN_Z_MM) & (
            -optics.dot(d, a) >= math.cos(math.radians(
                CLEAN_MAX_ANGLE_DEG)))

    def surface_residual(self, q, a):
        """mm off the body's skin of a point ``q`` relative to its PMT's
        center."""
        z, r2 = optics.local_axial(q, a)
        r = torch.sqrt(r2)
        zt = torch.as_tensor(self.z, device=q.device)
        rt = torch.as_tensor(self.r, device=q.device)
        zc = z.clamp(zt[0], zt[-1])
        j = torch.searchsorted(zt, zc, right=True).clamp(1, len(zt) - 1)
        rz = rt[j - 1] + (zc - zt[j - 1]) / (zt[j] - zt[j - 1]) \
            * (rt[j] - rt[j - 1])
        side = torch.where((z >= zt[0]) & (z <= zt[-1]), (r - rz).abs(),
                           math.inf)
        top = torch.where(r <= rt[-1], (z - zt[-1]).abs(), math.inf)
        bottom = torch.where(r <= rt[0], (z - zt[0]).abs(), math.inf)
        return torch.minimum(side, torch.minimum(top, bottom))


def reference(cfg, device):
    return SNOReference(cfg, device)

"""The SNO+-like detector: the SNO-like one with its vessel filled with
liquid scintillator (LAB + PPO), how the program's tables are built and
cached, and the plain reference the check holds its output against.

``load`` writes the detector's GDML and RATDB files into the cache
(``snoplus_like_gdml.py``), loads them through the program's
``rat.RATGeoLoader``, packs the flat tables once into the table cache
and serves every run from there.  ``FAULTS`` plant a fault in the loaded
tables, for the benchmark's tests of its check.  The reference is
``sno_like``'s, with the scintillator inside the vessel
(``reference/scint.py``).
"""
import dataclasses
import os

import torch

from portbench.configs import sno_like
from portbench.configs import snoplus_like_gdml as gdml
from portbench.reference import optics, scint


def load(cfg, device, cache_dir):
    """The program's GPUDetector from the table cache; on a miss the
    GDML is written, loaded and packed."""
    from chroma_tpu_torch import gpu
    name = cfg['table_cache']
    gg = gpu.GPUDetector.from_table_cache(name, device=device)
    if gg is None:
        from chroma_tpu_torch.detector import Detector
        from chroma_tpu_torch.rat import RATGeoLoader
        path, ratdb = gdml.snoplus_like_gdml(
            cfg['npmt'], os.path.join(cache_dir, 'snoplus', 'snoplus_%d.gdml'
                                      % cfg['npmt']), cfg['scintillator'])
        loader = RATGeoLoader(path, ratdb_file=ratdb)
        loader.add_pmt_info()
        inner = loader.materials_used[loader.material_lookup['scintillator']]
        det = loader.build_detector(detector=Detector(inner),
                                    volume_classifier=sno_like._sno_classifier)
        det.flatten()
        gpu.GPUDetector(det, device).save_table_cache(name)
        del det, loader
        gg = gpu.GPUDetector.from_table_cache(name, device=device)
    if gg.nchannels != cfg['channels']:
        raise RuntimeError('%s has %d channels, not %d'
                           % (name, gg.nchannels, cfg['channels']))
    if not gg.geom.has_reemission or gg.geom.max_comp != \
            len(cfg['scintillator']['abslength_mm']):
        raise RuntimeError('%s does not hold the scintillator\'s %d '
                           'components' % (name, len(
                               cfg['scintillator']['abslength_mm'])))
    return gg


def _scintillator_row(geom):
    """The packed tables' row of the one reemitting material."""
    rows = torch.nonzero(geom.num_comp > 0).flatten().tolist()
    if len(rows) != 1:
        raise RuntimeError('%d reemitting materials, not 1' % len(rows))
    return rows[0]


def _no_reemit(gg, cfg):
    """No absorption in the scintillator is reemitted: every
    component's reemission probability zeroed in the packed tables."""
    geom = gg.geom
    gg.geom = dataclasses.replace(
        geom, comp_reemission_prob=torch.zeros_like(
            geom.comp_reemission_prob))
    return gg


def _fluor_abs(gg, cfg):
    """The fluor (PPO, the last component) absorbing ten times too
    strongly, as a slip of units would: its absorption length cut
    tenfold in the packed tables and the total, 1 / sum(1 / L_c), with
    it.  The total alone sets where a photon is absorbed: the last
    component takes what the others leave."""
    geom = gg.geom
    m = _scintillator_row(geom)
    ppo = len(cfg['scintillator']['abslength_mm']) - 1
    comp = geom.comp_absorption_length.clone()
    old = geom.comp_absorption_length[m, ppo]
    comp[m, ppo] = 0.1 * old
    absorption = geom.absorption_length.clone()
    absorption[m] = 1.0 / (1.0 / absorption[m] + 1.0 / comp[m, ppo]
                           - 1.0 / old)
    gg.geom = dataclasses.replace(geom, absorption_length=absorption,
                                  comp_absorption_length=comp)
    return gg


FAULTS = {'no_reemit': _no_reemit, 'fluor_abs': _fluor_abs}


# ---- the reference ---------------------------------------------------

class SNOPlusReference(sno_like.SNOReference):
    """What the check knows of the SNO+-like detector: ``sno_like``'s
    PMTs and vessel, the scintillator inside it."""

    def __init__(self, cfg, device):
        super(SNOPlusReference, self).__init__(cfg, device)
        self.scint = scint.Scintillator(cfg['scintillator'])
        water, acrylic = self.media.media[0], self.media.media[1]
        r_av = cfg['av_radius_mm']
        self.inner_radius = r_av - cfg['av_wall_mm']
        self.media = optics.Media(water, [(r_av, acrylic),
                                          (self.inner_radius,
                                           self.scint.medium)])


def reference(cfg, device):
    return SNOPlusReference(cfg, device)

"""Photon sources (counterpart of chroma_tpu/generator/photon.py).

Only ``photon_bomb`` is carried: the port simulates photon input.
Photon generation from particle vertices (the Geant4 / track-generator
worker pool) is not ported.
"""
import numpy as np

from chroma_tpu_torch import event
from chroma_tpu_torch.sample import uniform_sphere


def photon_bomb(n, wavelength, pos, t0=0.0):
    """An Event of n isotropic monochromatic photons from a point."""
    pos = np.tile(pos, (n, 1)).astype(np.float32)
    dir = uniform_sphere(n).astype(np.float32)
    pol = np.cross(uniform_sphere(n), dir).astype(np.float32)
    pol /= np.linalg.norm(pol, axis=1)[:, None]
    wavelengths = np.full(n, wavelength, dtype=np.float32)
    t = np.full(n, t0, dtype=np.float32)
    return event.Event(photons_beg=event.Photons(
        pos=pos, dir=dir, pol=pol, wavelengths=wavelengths, t=t))

"""Wavelength -> RGB conversion (counterpart of
chroma_tpu/color/chromaticity.py; reference: chroma/color/chromaticity.py).

The reference interpolates tabulated CIE color-matching CSV data; here
we use the standard piecewise-Gaussian analytic fit to the CIE 1931
color matching functions (Wyman, Sloan & Shirley 2013), which needs no
data files.
"""
import numpy as np


def _gauss(x, alpha, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return alpha * np.exp(-0.5 * ((x - mu) / s) ** 2)


def cie_xyz(wavelength):
    """CIE 1931 XYZ color matching values for wavelengths in nm."""
    w = np.asarray(wavelength, dtype=float)
    x = (_gauss(w, 1.056, 599.8, 37.9, 31.0)
         + _gauss(w, 0.362, 442.0, 16.0, 26.7)
         + _gauss(w, -0.065, 501.1, 20.4, 26.2))
    y = (_gauss(w, 0.821, 568.8, 46.9, 40.5)
         + _gauss(w, 0.286, 530.9, 16.3, 31.1))
    z = (_gauss(w, 1.217, 437.0, 11.8, 36.0)
         + _gauss(w, 0.681, 459.0, 26.0, 13.8))
    return np.stack([x, y, z], axis=-1)


# sRGB conversion matrix (linear)
_XYZ_TO_RGB = np.array([[3.2406, -1.5372, -0.4986],
                        [-0.9689, 1.8758, 0.0415],
                        [0.0557, -0.2040, 1.0570]])


def map_wavelength(wavelength):
    """(..., 3) RGB in [0,1] for wavelengths in nm."""
    xyz = cie_xyz(wavelength)
    rgb = xyz @ _XYZ_TO_RGB.T
    rgb = np.clip(rgb, 0.0, None)
    peak = rgb.max(axis=-1, keepdims=True)
    rgb = np.where(peak > 0, rgb / np.maximum(peak, 1e-12), rgb)
    return np.clip(rgb, 0.0, 1.0)

"""Demo optical properties: water, glass, photocathode, simple surfaces.

Role parity with the reference demo optics (reference:
chroma/demo/optics.py), but the tables here are generated from standard
empirical formulas instead of embedded digitized data:

  * water refractive index: Quan & Fry (1995) empirical equation for
    seawater at S=0, T=20 C — the same formula family WCSim's water
    model derives from.
  * water absorption: smooth interpolation of the published pure-water
    absorption minimum (Pope & Fry 1997 scale): very transparent in the
    blue (~100 m), opaque in UV and red.
  * water Rayleigh scattering: lambda^-4 scaling anchored to ~70 m at
    400 nm (Einstein-Smoluchowski scale used by water Cherenkov
    detectors).
  * photocathode quantum efficiency: smooth bialkali response peaked at
    ~385 nm with max QE ~32% (8-inch high-QE class tube).

All lengths are in mm, wavelengths in nm.
"""
import numpy as np

from chroma_tpu_torch.geometry import Material, Surface

vacuum = Material('vacuum')
vacuum.set('refractive_index', 1.0)
vacuum.set('absorption_length', 1e6)
vacuum.set('scattering_length', 1e6)


# ----- simple surfaces ------------------------------------------------

lambertian_surface = Surface('lambertian_surface')
lambertian_surface.set('reflect_diffuse', 1)

black_surface = Surface('black_surface')
black_surface.set('absorb', 1)

shiny_surface = Surface('shiny_surface')
shiny_surface.set('reflect_specular', 1)

glossy_surface = Surface('glossy_surface')
glossy_surface.set('reflect_diffuse', 0.5)
glossy_surface.set('reflect_specular', 0.5)

red_absorb_surface = Surface('red_absorb')
red_absorb_surface.set('absorb', [0.0, 0.0, 1.0], [465, 545, 685])
red_absorb_surface.set('reflect_diffuse', [1.0, 1.0, 0.0], [465, 545, 685])


# ----- water ----------------------------------------------------------

def water_refractive_index(wavelength_nm):
    """Quan & Fry (Applied Optics 34, 1995) empirical refractive index
    of water, S=0 (pure), T=20 C."""
    lam = np.asarray(wavelength_nm, dtype=float)
    T, S = 20.0, 0.0
    n = (1.31405
         + (1.779e-4 + -1.05e-6 * T + 1.6e-8 * T * T) * S
         - 2.02e-6 * T * T
         + (15.868 + 0.01155 * S - 0.00423 * T) / lam
         - 4382.0 / lam ** 2
         + 1.1455e6 / lam ** 3)
    return n


# Pure-water absorption coefficient anchors (1/m), smooth envelope of
# the published pure-water data (Pope & Fry 1997 in the visible,
# standard UV/IR extrapolations).  Interpolated in log space.
_ABS_WL = np.array([200., 250., 300., 320., 350., 380., 400., 420., 450.,
                    480., 500., 550., 600., 650., 700., 750., 800., 1000.])
_ABS_COEF = np.array([3.0, 0.6, 0.15, 0.08, 0.025, 0.012, 0.0066, 0.0045,
                      0.0092, 0.0127, 0.0204, 0.0565, 0.222, 0.34, 0.624,
                      2.47, 2.07, 10.0])


def water_absorption_length_mm(wavelength_nm):
    """Pure-water absorption length in mm (log-interpolated anchors)."""
    lam = np.asarray(wavelength_nm, dtype=float)
    coef = np.exp(np.interp(lam, _ABS_WL, np.log(_ABS_COEF)))
    return 1000.0 / coef  # 1/m -> mm


def water_scattering_length_mm(wavelength_nm, anchor_nm=400.0,
                               anchor_mm=70.0e3):
    """Rayleigh scattering length ~ lambda^4, anchored at 70 m @ 400 nm."""
    lam = np.asarray(wavelength_nm, dtype=float)
    return anchor_mm * (lam / anchor_nm) ** 4


_water_grid = np.arange(200.0, 805.0, 5.0)

water = Material('water')
water.density = 1.0  # g/cm^3
water.composition = {'H': 0.1119, 'O': 0.8881}
water.set('refractive_index', water_refractive_index(_water_grid),
          wavelengths=_water_grid)
water.set('absorption_length', water_absorption_length_mm(_water_grid),
          wavelengths=_water_grid)
water.set('scattering_length', water_scattering_length_mm(_water_grid),
          wavelengths=_water_grid)


# ----- PMT glass ------------------------------------------------------

glass = Material('glass')
glass.set('refractive_index', 1.49)
# borosilicate window: transparent 330-770 nm, opaque in deep UV/IR
_GLASS_WL = np.array([200., 300., 330., 500., 600., 770., 800., 1000.])
_GLASS_ABS = np.array([1e-7, 1e-7, 1000., 2000., 1000., 500., 1e-7, 1e-7])
glass.absorption_length = np.column_stack(
    (_GLASS_WL, _GLASS_ABS)).astype(np.float32)
glass.set('scattering_length', 1e6)


# ----- photocathode ---------------------------------------------------

def bialkali_qe(wavelength_nm, peak_nm=385.0, max_qe=0.322):
    """Smooth bialkali quantum-efficiency curve: asymmetric gaussian in
    log-wavelength with a hard UV cutoff at the glass transmission edge
    and a long red tail, shaped to the published response of 8-inch
    high-QE hemispherical tubes (peak ~32% at ~390 nm, sensitive
    ~280-700 nm)."""
    lam = np.asarray(wavelength_nm, dtype=float)
    x = np.log(lam / peak_nm)
    sigma = np.where(x < 0, 0.105, 0.187)  # steeper on the UV side
    qe = max_qe * np.exp(-0.5 * (x / sigma) ** 2)
    # UV glass cutoff: transmission collapses below ~300 nm
    qe *= 1.0 / (1.0 + np.exp(-(lam - 295.0) / 6.0))
    return np.where((lam < 250.0) | (lam > 720.0), 0.0, qe)


_qe_grid = np.arange(250.0, 725.0, 5.0)
_qe = bialkali_qe(_qe_grid)

r7081hqe_photocathode = Surface('r7081hqe_photocathode')
r7081hqe_photocathode.set('detect', _qe, wavelengths=_qe_grid)
# roughly as many photons are absorbed without detection as detected
r7081hqe_photocathode.set('absorb', _qe, wavelengths=_qe_grid)
# the remainder reflect diffusely
r7081hqe_photocathode.set('reflect_diffuse', 1.0 - 2.0 * _qe,
                          wavelengths=_qe_grid)

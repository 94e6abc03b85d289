"""The host layer a caller of the port builds scenes and photons with.

Geometry construction, the demo detectors, photon sources and the event
model are plain numpy.  The port keeps its own copies of the JAX
package's host modules (event, geometry, detector, make, demo, loader,
cache, bvh, native, generator.photon, ...), under the same module names
inside ``chroma_tpu_torch``; this module re-exports what scripts such as
chip_smoke.py need, so they import from one place.
"""
import numpy as np

from chroma_tpu_torch import demo, event, make  # noqa: F401
from chroma_tpu_torch.geometry import Geometry, Solid, vacuum  # noqa: F401
from chroma_tpu_torch.generator.photon import photon_bomb  # noqa: F401


def tie_geometry():
    """Two coincident copies of one sphere (radius 50), placed as two
    solids of one mesh: every triangle has a twin at the same distance,
    and packed with ``instancing=True`` the two instance entries have
    equal boxes, so walks meet ties in hit distance and in entry codes,
    which the lowest-slot rule decides."""
    mesh = make.sphere(50.0, nsteps=16)
    geo = Geometry(vacuum)
    for _ in range(2):
        geo.add_solid(Solid(mesh, vacuum, vacuum))
    geo.flatten()
    return geo


def axis_rays(origin=(0.731, -1.37, 2.113)):
    """(6, 3) origins and directions: one ray along each of +-x, +-y, +-z
    from ``origin`` (1/dir is infinite on two axes)."""
    d = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                  [0, 0, -1]], dtype=np.float32)
    o = np.tile(np.asarray(origin, np.float32), (6, 1))
    return o, d


def mesh_geometry(mesh):
    """A flattened single-solid Geometry (vacuum on both sides) around a
    Mesh, as the tests pack single meshes."""
    geo = Geometry(vacuum)
    geo.add_solid(Solid(mesh, vacuum, vacuum))
    geo.flatten()
    return geo


# ---- gate boxes: one small scene per gated physics model -----------------
# A 100 mm cube that carries the model under test, centred in a 300 mm
# cube whose walls are a pure counter (detect + absorb = 1, no
# reflection: the surface for which weighted propagation is an unbiased
# estimator of the detected count).  The counter is blind above 550 nm,
# and every reemission spectrum lies there, so reemitted photons (which
# weighted propagation never makes) are not counted in either mode.
GATES = ('reemission', 'wls', 'dichroic', 'complex')
COUNTER_DETECT = 0.3
REEMIT_PEAK, REEMIT_WIDTH = 700.0, 30.0      # nm, normal spectrum
SCINT_ABSORPTION, SCINT_REEMIT = 200.0, 0.8  # mm, probability
WLS_ABSORB, WLS_REEMIT, WLS_RSPEC, WLS_RDIFF = 0.6, 0.5, 0.12, 0.08
# dichroic control points: rows are angles (rad), columns wavelengths (nm)
DICH_ANGLES = np.array([0.0, np.pi / 3, np.pi / 2])
DICH_WL = np.array([250.0, 450.0, 800.0])
DICH_R = np.array([[0.10, 0.50, 0.10], [0.30, 0.70, 0.30],
                   [0.90, 0.90, 0.90]])
DICH_T = np.array([[0.80, 0.40, 0.80], [0.55, 0.20, 0.55],
                   [0.05, 0.05, 0.05]])
FILM_ETA, FILM_K, FILM_THICKNESS = 2.7, 1.5, 25e-6   # thickness in mm
FILM_RDIFF = 0.25           # diffuse share of the film's reflections
MURKY_INDEX, MURKY_ABSORPTION, MURKY_SCATTERING = 1.33, 150.0, 100.0


def _normal_cdf(x, mean, width):
    from math import erf, sqrt
    return np.array([0.5 * (1.0 + erf((v - mean) / (width * sqrt(2.0))))
                     for v in x])


def gate_box(gate, murky=False, film_detect=0.0, geometry=None, make=None):
    """The flattened gate box of ``gate`` (one of ``GATES``).

    ``murky`` fills the scene with a scattering, absorbing medium (index
    1.33) in place of vacuum, so first-interaction scattering matters;
    ``film_detect`` is the detection efficiency of the 'complex' gate's
    thin film.  ``geometry`` and ``make`` are the modules to build with
    (default: the port's own), so another package with the same host API
    can build the same scene."""
    if geometry is None:
        from chroma_tpu_torch import geometry
    if make is None:
        from chroma_tpu_torch import make
    G = geometry
    x = np.arange(60.0, 1000.0, 5.0)
    spectrum = _normal_cdf(x, REEMIT_PEAK, REEMIT_WIDTH)

    medium = G.vacuum
    if murky:
        medium = G.Material('murky')
        medium.set('refractive_index', MURKY_INDEX)
        medium.set('absorption_length', MURKY_ABSORPTION)
        medium.set('scattering_length', MURKY_SCATTERING)

    counter = G.Surface('counter')
    edge = [60.0, 500.0, 550.0, 1000.0]
    counter.set('detect', [COUNTER_DETECT, COUNTER_DETECT, 0.0, 0.0],
                wavelengths=edge)
    counter.set('absorb', [1 - COUNTER_DETECT, 1 - COUNTER_DETECT, 1.0, 1.0],
                wavelengths=edge)

    inner, surface = medium, None
    if gate == 'reemission':
        inner = G.Material('scint')
        inner.set('refractive_index', MURKY_INDEX if murky else 1.0)
        inner.set('absorption_length', SCINT_ABSORPTION)
        inner.set('scattering_length',
                  MURKY_SCATTERING if murky else 1e7)
        inner.add_reemission_component(
            reemission_prob=np.column_stack(
                [x, np.full_like(x, SCINT_REEMIT)]),
            wvl_cdf=np.column_stack([x, spectrum]))
    elif gate == 'wls':
        surface = G.Surface('wls', model=G.SURFACE_WLS)
        surface.set('absorb', WLS_ABSORB)
        surface.set('reemit', WLS_REEMIT)
        surface.set('reflect_specular', WLS_RSPEC)
        surface.set('reflect_diffuse', WLS_RDIFF)
        surface.set('reemission_cdf', spectrum, wavelengths=x)
    elif gate == 'dichroic':
        surface = G.Surface('dichroic', model=G.SURFACE_DICHROIC)
        surface.dichroic_props = G.DichroicProps(
            DICH_ANGLES,
            [np.column_stack([DICH_WL, DICH_R[a]]) for a in range(3)],
            [np.column_stack([DICH_WL, DICH_T[a]]) for a in range(3)])
    elif gate == 'complex':
        surface = G.Surface('film', model=G.SURFACE_COMPLEX)
        surface.set('eta', FILM_ETA)
        surface.set('k', FILM_K)
        surface.set('detect', film_detect)
        surface.set('reflect_diffuse', FILM_RDIFF)
        surface.thickness = FILM_THICKNESS
        surface.transmissive = 1
    else:
        raise ValueError('gate must be one of %s, got %r' % (GATES, gate))

    geo = G.Geometry(medium)
    geo.add_solid(G.Solid(make.box(300.0, 300.0, 300.0), medium, medium,
                          surface=counter))
    geo.add_solid(G.Solid(make.box(100.0, 100.0, 100.0), inner, medium,
                          surface=surface))
    geo.flatten()
    return geo


def dichroic_expect(theta, wl):
    """(reflect, transmit) of the dichroic gate box at incidence angle
    ``theta`` and wavelength ``wl``: linear in angle between the rows of
    the control points, linear in wavelength within a row."""
    ai = int(np.searchsorted(DICH_ANGLES, theta, side='right')) - 1
    ai = min(max(ai, 0), len(DICH_ANGLES) - 2)
    af = (theta - DICH_ANGLES[ai]) / (DICH_ANGLES[ai + 1] - DICH_ANGLES[ai])
    r = [np.interp(wl, DICH_WL, DICH_R[a]) for a in (ai, ai + 1)]
    t = [np.interp(wl, DICH_WL, DICH_T[a]) for a in (ai, ai + 1)]
    return r[0] + (r[1] - r[0]) * af, t[0] + (t[1] - t[0]) * af


def film_normal_rt(n1, n3, wl):
    """(R, T) of the 'complex' gate's film at normal incidence between
    real indices ``n1`` and ``n3``, by the Airy summation in complex128
    (independent of ops/propagate.thin_film_rta's formulation)."""
    n2 = complex(FILM_ETA, FILM_K)
    beta = 2.0 * np.pi * n2 * (FILM_THICKNESS * 1e6) / wl
    r12, r23 = (n1 - n2) / (n1 + n2), (n2 - n3) / (n2 + n3)
    t12, t23 = 2 * n1 / (n1 + n2), 2 * n2 / (n2 + n3)
    phase = np.exp(2j * beta)
    r = (r12 + r23 * phase) / (1 + r12 * r23 * phase)
    t = t12 * t23 * np.exp(1j * beta) / (1 + r12 * r23 * phase)
    return abs(r) ** 2, n3 / n1 * abs(t) ** 2


def beam_photons(n, theta=0.0, wavelength=400.0, seed=5):
    """n photons from the origin towards the +z wall at incidence angle
    ``theta`` (rad), polarized at random about the direction."""
    pos = np.zeros((n, 3), dtype=np.float32)
    dirv = np.tile([np.sin(theta), 0.0, np.cos(theta)],
                   (n, 1)).astype(np.float32)
    phi = np.random.RandomState(seed).uniform(0, 2 * np.pi, n)
    pol = np.stack([np.cos(theta) * np.cos(phi), np.sin(phi),
                    -np.sin(theta) * np.cos(phi)], axis=1)
    return event.Photons(pos=pos, dir=dirv, pol=pol.astype(np.float32),
                         wavelengths=np.full(n, wavelength, np.float32))

"""Generic PMT solid construction (counterpart of chroma_tpu/pmt.py;
reference: chroma/pmt.py).

A PMT is two nested revolution surfaces (outer glass envelope, inner
vacuum envelope offset inward by the glass thickness).  Triangles of
the inner envelope above the equator (y > 0) get the photocathode
surface; the rest get the back surface.
"""
import numpy as np

from chroma_tpu_torch.geometry import Solid
from chroma_tpu_torch.make import rotate_extrude
from chroma_tpu_torch.tools import read_csv, offset


def build_pmt_from_profile(profile, glass_thickness, outer_material, glass,
                           vacuum, photocathode_surface, back_surface,
                           nsteps=16):
    """Build a PMT from an (n,2) closed profile (r, y), base to face,
    with r[0] == r[-1] == 0 so the revolution closes."""
    profile = np.asarray(profile, dtype=float)
    offset_profile = offset(profile, -glass_thickness)

    outer_mesh = rotate_extrude(profile[:, 0], profile[:, 1], nsteps)
    inner_mesh = rotate_extrude(offset_profile[:, 0], offset_profile[:, 1],
                                nsteps)

    outer_envelope = Solid(outer_mesh, glass, outer_material)

    # photocathode covers the front (y > 0) half of the inner envelope
    photocathode = np.mean(inner_mesh.assemble(), axis=1)[:, 1] > 0
    inner_envelope = Solid(
        inner_mesh, vacuum, glass,
        surface=np.where(photocathode, photocathode_surface, back_surface),
        color=np.where(photocathode, 0xff00, 0xff0000))

    pmt = outer_envelope + inner_envelope

    # stash construction info for light-collector builders.  NOTE: kept
    # under a name that does not clobber the per-triangle
    # ``outer_material`` array (the reference overwrites it:
    # chroma/pmt.py:72, which breaks later Solid concatenation).
    pmt.profile = profile
    pmt.construction_material = outer_material
    pmt.nsteps = nsteps
    return pmt


def build_pmt(filename, glass_thickness, outer_material, glass, vacuum,
              photocathode_surface, back_surface, nsteps=16):
    """Build a PMT from a 2-column CSV profile file (reference:
    chroma/pmt.py:40).  The file profile is sliced to its x<0 half,
    mirrored and ordered base-to-face."""
    profile = read_csv(filename)
    profile = profile[profile[:, 0] < 0]
    profile[:, 0] = -profile[:, 0]
    profile = profile[np.argsort(profile[:, 1])]
    profile[0, 0] = 0.0
    profile[-1, 0] = 0.0
    return build_pmt_from_profile(profile, glass_thickness, outer_material,
                                  glass, vacuum, photocathode_surface,
                                  back_surface, nsteps)


def build_pmt_shell(filename, outer_material, glass, nsteps=16):
    """Hollow glass shell only (no inner envelope)."""
    profile = read_csv(filename)
    profile = profile[profile[:, 0] < 0]
    profile[:, 0] = -profile[:, 0]
    profile = profile[np.argsort(profile[:, 1])]
    profile[0, 0] = 0.0
    profile[-1, 0] = 0.0
    return Solid(rotate_extrude(profile[:, 0], profile[:, 1], nsteps),
                 glass, outer_material, color=0xeeffffff)


def get_lc_profile(radii, a, b, d, rmin, rmax):
    """Elliptical light-collector profile (reference: chroma/pmt.py:7)."""
    c = -b * np.sqrt(1 - (rmin - d) ** 2 / a ** 2)
    return -c - b * np.sqrt(1 - (radii - d) ** 2 / a ** 2)


def build_light_collector(pmt, a, b, d, rmin, rmax, surface, npoints=10):
    """Light-collector cone matched to the face profile of ``pmt``."""
    if not isinstance(pmt, Solid):
        raise Exception('`pmt` must be an instance of %s' % Solid)
    lc_radii = np.linspace(rmin, rmax, npoints)
    lc_profile = get_lc_profile(lc_radii, a, b, d, rmin, rmax)

    pmt_face_profile = pmt.profile[pmt.profile[:, 1] > -1e-3]
    lc_offset = np.interp(lc_radii[0],
                          list(reversed(pmt_face_profile[:, 0])),
                          list(reversed(pmt_face_profile[:, 1])))
    lc_mesh = rotate_extrude(lc_radii, lc_profile + lc_offset, pmt.nsteps)
    material = pmt.construction_material
    return Solid(lc_mesh, material, material, surface=surface)


def build_light_collector_from_file(filename, outer_material, surface,
                                    nsteps=48):
    profile = read_csv(filename)
    mesh = rotate_extrude(profile[:, 0], profile[:, 1], nsteps)
    return Solid(mesh, outer_material, outer_material, surface=surface)

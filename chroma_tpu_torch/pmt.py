"""Generic PMT solid construction (counterpart of chroma_tpu/pmt.py, cut
to what the demo detectors build; reference: chroma/pmt.py).

A PMT is two nested revolution surfaces (outer glass envelope, inner
vacuum envelope offset inward by the glass thickness).  Triangles of
the inner envelope above the equator (y > 0) get the photocathode
surface; the rest get the back surface.
"""
import numpy as np

from chroma_tpu_torch.geometry import Solid
from chroma_tpu_torch.make import rotate_extrude
from chroma_tpu_torch.tools import offset


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

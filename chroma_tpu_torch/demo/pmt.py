"""Analytic 8-inch PMT solid for the demo detector.

The reference builds its demo PMT by revolving a digitized SNO PMT
profile (reference: chroma/demo/pmt.py + sno_pmt.txt).  Here the
profile is generated analytically: a spherical photocathode cap, a
toroidal shoulder blend, a cylindrical neck and a closed base — the
standard hemispherical-PMT shape.  The profile runs base-to-face with
x = radius >= 0 and y the symmetry axis (face towards +y), closed at
both ends (x=0), ready for rotate_extrude.
"""
import numpy as np

from chroma_tpu_torch.geometry import Solid
from chroma_tpu_torch.make import rotate_extrude
from chroma_tpu_torch.pmt import build_pmt_from_profile
from chroma_tpu_torch.demo.optics import (water, glass, vacuum, shiny_surface,
                                    r7081hqe_photocathode)


def pmt_profile(face_radius=126.5, bulb_height=95.0, neck_radius=42.0,
                neck_length=160.0, npoints_face=24, npoints_neck=8):
    """(n,2) profile (r, y) of an 8-inch class PMT, base to face.

    The bulb is a sphere-section of radius ``face_radius``; below the
    equator it tapers to the neck with a smooth cosine blend.
    """
    # face: spherical cap from equator (theta=0) to pole (theta=pi/2)
    theta = np.linspace(0.0, np.pi / 2, npoints_face)
    face_r = face_radius * np.cos(theta)
    face_y = face_radius * np.sin(theta) * (bulb_height / face_radius) \
        + bulb_height * 0.0
    # scale: slightly oblate bulb (height < radius like real tubes)
    face_y = bulb_height * np.sin(theta)

    # shoulder: blend from bulb equator down to neck radius
    blend = np.linspace(0.0, 1.0, 10, endpoint=False)[1:]
    shoulder_r = neck_radius + (face_radius - neck_radius) \
        * 0.5 * (1 + np.cos(np.pi * blend))
    shoulder_y = -bulb_height * 0.9 * blend

    # neck: straight wall down to the base
    neck_y = np.linspace(shoulder_y[-1] - 5.0,
                         shoulder_y[-1] - neck_length, npoints_neck)
    neck_r = np.full_like(neck_y, neck_radius)

    r = np.concatenate([[0.0], neck_r[::-1], shoulder_r[::-1],
                        face_r[::-1][1:]])
    y = np.concatenate([[neck_y[-1]], neck_y[::-1], shoulder_y[::-1],
                        face_y[::-1][1:]])
    # close the face at the axis
    r[-1] = 0.0
    return np.column_stack([r, y])


def lc_profile(rmin=126.5, rmax=161.0, height=50.0, npoints=10):
    """Winston-style light-collector cone profile (r, y), open both ends."""
    r = np.linspace(rmin, rmax, npoints)
    # quarter-ellipse flare
    y = height * np.sqrt(np.clip(1 - ((r - rmin) / (rmax - rmin)) ** 2,
                                 0, 1)) - height
    return np.column_stack([r, -y])


def build_8inch_pmt(outer_material=water, nsteps=24):
    """Glass/vacuum PMT with photocathode on the front hemisphere."""
    return build_pmt_from_profile(
        pmt_profile(), glass_thickness=3.0, outer_material=outer_material,
        glass=glass, vacuum=vacuum,
        photocathode_surface=r7081hqe_photocathode,
        back_surface=shiny_surface, nsteps=nsteps)


def build_8inch_pmt_with_lc(outer_material=water, nsteps=24):
    """8-inch PMT plus a reflective light-collector cone at the face."""
    pmt = build_8inch_pmt(outer_material, nsteps)
    profile = lc_profile()
    lc_mesh = rotate_extrude(profile[:, 0], profile[:, 1], nsteps)
    lc = Solid(lc_mesh, outer_material, outer_material,
               surface=shiny_surface)
    return pmt + lc

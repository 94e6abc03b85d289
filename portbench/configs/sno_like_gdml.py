"""Writer of the SNO-like detector's GDML and RATDB files.

A copy of chip_smoke.py's ``sno_like_gdml``: the benchmark writes the
files its ``sno_like`` configuration loads, and its reference reads the
same constants.  Layout from J. Boger et al., "The Sudbury Neutrino
Observatory", Nucl. Instrum. Meth. A449 (2000) 172: a 6.0 m acrylic
vessel (5.5 cm wall) holding heavy water, in light water, and inward-
looking PMTs with 27 cm light concentrators on a 8.89 m sphere.  PMTs
are placed on a Fibonacci sphere, not on the paper's geodesic panels.
The vessel is an acrylic orb holding a heavy-water orb: the GDML loader
meshes a hollow <sphere> inside out.
"""
import json
import os

import numpy as np

SNO_PSUP_RADIUS = 8890.0        # mm, PMT origins
SNO_AV_RADIUS = 6000.0          # mm, outer radius of the acrylic vessel
SNO_AV_WALL = 55.0              # mm
# PMT body (glass, detecting skin): a 9-plane polycone along local +z,
# the face toward the center at z > 0
SNO_BODY_Z = (-250.0, -180.0, -130.0, -90.0, -60.0, -30.0, 0.0, 25.0, 40.0)
SNO_BODY_R = (35.0, 42.0, 50.0, 80.0, 97.0, 101.0, 98.0, 80.0, 50.0)
# light concentrator (aluminium, polished reflective skin): a hollow
# polycone 2 mm thick, 270 mm across at its mouth, clear of the body
SNO_CONC_Z = (-40.0, 10.0, 60.0, 110.0)
SNO_CONC_RMIN = (108.0, 115.0, 125.0, 133.0)
SNO_CONC_WALL = 2.0
_ENERGIES = (1.5e-6, 2.5e-6, 3.5e-6, 5.0e-6)     # MeV: 827 to 248 nm
# the optical tables, one value an energy of _ENERGIES
TABLES = {
    'RI_WATER': (1.33, 1.335, 1.34, 1.36),
    'ABS_WATER': (20000.0, 60000.0, 40000.0, 5000.0),
    'RS_WATER': (200000.0, 90000.0, 60000.0, 15000.0),
    'ABS_D2O': (30000.0, 90000.0, 60000.0, 8000.0),
    'RI_ACRYLIC': (1.49, 1.495, 1.505, 1.53),
    'ABS_ACRYLIC': (5000.0, 5000.0, 2000.0, 100.0),
    'RI_GLASS': (1.47, 1.475, 1.48, 1.5),
    'ABS_OPAQUE': (0.01, 0.01, 0.01, 0.01),
    'EFF_PMT': (0.02, 0.2, 0.25, 0.1),
    'REFL_CONC': (0.85, 0.85, 0.8, 0.7),
}


def _gdml_matrix(name, values):
    return ('    <matrix name="%s" coldim="2" values="%s"/>\n'
            % (name, ' '.join('%r %r' % (e, v)
                              for e, v in zip(_ENERGIES, values))))


def _fibonacci_sphere(n, radius):
    """(n, 3) points spread evenly over a sphere (golden-angle spiral)."""
    i = np.arange(n) + 0.5
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(1.0 - z * z)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    return radius * np.column_stack([r * np.cos(phi), r * np.sin(phi), z])


def sno_pmt_placements(npmt):
    """(positions (n, 3) mm, GDML Euler angles (n, 3) rad) of ``npmt``
    PMTs facing the center.  Positions are rounded to the 1e-6 mm the
    GDML and RATDB files carry.  The loader turns angles (a, b, c) into
    R = Rx(a) Ry(b) Rz(c) with ``make_rotation_matrix`` (a rotation by
    -angle about each axis) and places vertices at R v: a = atan2(dy, dz)
    and b = -asin(dx) send local +z to d = -pos / |pos|."""
    pos = np.round(_fibonacci_sphere(npmt, SNO_PSUP_RADIUS), 6)
    d = -pos / np.linalg.norm(pos, axis=1, keepdims=True)
    angles = np.column_stack([np.arctan2(d[:, 1], d[:, 2]),
                              -np.arcsin(np.clip(d[:, 0], -1.0, 1.0)),
                              np.zeros(npmt)])
    return pos, angles


def sno_like_gdml(npmt, path):
    """Write a SNO-like detector of ``npmt`` PMTs as ``path`` (GDML) and
    ``path`` with '.ratdb.json' (RATDB: a GEO pmtarray and its PMTINFO
    table holding the same positions).  Returns (gdml path, ratdb
    path)."""
    pos, angles = sno_pmt_placements(npmt)
    out = ['<?xml version="1.0" encoding="UTF-8" standalone="no" ?>\n',
           '<gdml>\n  <define>\n']
    for name, values in TABLES.items():
        out.append(_gdml_matrix(name, values))
    for i, (p, a) in enumerate(zip(pos, angles)):
        out.append('    <position name="pmtpos%d" unit="mm" x="%r" y="%r" '
                   'z="%r"/>\n' % (i, *map(float, p)))
        out.append('    <rotation name="pmtrot%d" unit="rad" x="%r" y="%r" '
                   'z="%r"/>\n' % (i, *map(float, a)))
    out.append('  </define>\n  <materials>\n')
    # element mass fractions (what the track generator's energy loss
    # reads); deuterium stands as H
    for name, density, elements, props in (
            ('water', 1.0, (('H', 0.1119), ('O', 0.8881)),
             (('RINDEX', 'RI_WATER'), ('ABSLENGTH', 'ABS_WATER'),
              ('RSLENGTH', 'RS_WATER'))),
            ('heavy_water', 1.105, (('H', 0.2011), ('O', 0.7989)),
             (('RINDEX', 'RI_WATER'), ('ABSLENGTH', 'ABS_D2O'),
              ('RSLENGTH', 'RS_WATER'))),
            ('acrylic', 1.18, (('C', 0.5998), ('H', 0.0805), ('O', 0.3197)),
             (('RINDEX', 'RI_ACRYLIC'), ('ABSLENGTH', 'ABS_ACRYLIC'))),
            ('glass', 2.23, (('Si', 0.4674), ('O', 0.5326)),
             (('RINDEX', 'RI_GLASS'), ('ABSLENGTH', 'ABS_OPAQUE'))),
            ('aluminium', 2.7, (('Al', 1.0),), (('ABSLENGTH', 'ABS_OPAQUE'),))):
        out.append('    <material name="%s">\n      <D value="%r" '
                   'unit="g/cm3"/>\n' % (name, density))
        for element, fraction in elements:
            out.append('      <fraction n="%r" ref="%s"/>\n'
                       % (fraction, element))
        for prop, ref in props:
            out.append('      <property name="%s" ref="%s"/>\n' % (prop, ref))
        out.append('    </material>\n')
    conc_planes = ''.join(
        '      <zplane z="%r" rmin="%r" rmax="%r"/>\n'
        % (z, r, r + SNO_CONC_WALL) for z, r in zip(SNO_CONC_Z,
                                                     SNO_CONC_RMIN))
    out += [
        '  </materials>\n  <solids>\n',
        '    <box name="world_s" lunit="mm" x="22000" y="22000" '
        'z="22000"/>\n',
        '    <orb name="av_s" lunit="mm" r="%r"/>\n' % SNO_AV_RADIUS,
        '    <orb name="d2o_s" lunit="mm" r="%r"/>\n'
        % (SNO_AV_RADIUS - SNO_AV_WALL),
        '    <polycone name="pmt_body_s" lunit="mm" aunit="deg" '
        'startphi="0" deltaphi="360">\n',
        ''.join('      <zplane z="%r" rmin="0" rmax="%r"/>\n' % (z, r)
                for z, r in zip(SNO_BODY_Z, SNO_BODY_R)),
        '    </polycone>\n',
        '    <polycone name="pmt_conc_s" lunit="mm" aunit="deg" '
        'startphi="0" deltaphi="360">\n', conc_planes, '    </polycone>\n',
        '    <opticalsurface name="photocathode" model="glisur" '
        'finish="polished" type="dielectric_metal" value="1.0">\n'
        '      <property name="EFFICIENCY" ref="EFF_PMT"/>\n'
        '    </opticalsurface>\n',
        '    <opticalsurface name="concentrator" model="glisur" '
        'finish="polished" type="dielectric_metal" value="1.0">\n'
        '      <property name="REFLECTIVITY" ref="REFL_CONC"/>\n'
        '    </opticalsurface>\n',
        '  </solids>\n  <structure>\n',
        '    <volume name="pmt_body_log">\n      <materialref ref="glass"/>\n'
        '      <solidref ref="pmt_body_s"/>\n    </volume>\n',
        '    <volume name="pmt_conc_log">\n'
        '      <materialref ref="aluminium"/>\n'
        '      <solidref ref="pmt_conc_s"/>\n    </volume>\n',
        '    <volume name="d2o_log">\n'
        '      <materialref ref="heavy_water"/>\n'
        '      <solidref ref="d2o_s"/>\n    </volume>\n',
        '    <volume name="av_log">\n      <materialref ref="acrylic"/>\n'
        '      <solidref ref="av_s"/>\n'
        '      <physvol name="d2o_phys">\n'
        '        <volumeref ref="d2o_log"/>\n      </physvol>\n'
        '    </volume>\n',
        '    <volume name="world_log">\n      <materialref ref="water"/>\n'
        '      <solidref ref="world_s"/>\n',
        '      <physvol name="av_phys">\n        <volumeref ref="av_log"/>\n'
        '      </physvol>\n']
    for i in range(npmt):
        for part in ('body', 'conc'):
            out.append('      <physvol name="pmt_%s_phys%d">\n'
                       '        <volumeref ref="pmt_%s_log"/>\n'
                       '        <positionref ref="pmtpos%d"/>\n'
                       '        <rotationref ref="pmtrot%d"/>\n'
                       '      </physvol>\n' % (part, i, part, i, i))
    out += [
        '    </volume>\n',
        '    <skinsurface name="photocathode_skin" '
        'surfaceproperty="photocathode">\n'
        '      <volumeref ref="pmt_body_log"/>\n    </skinsurface>\n',
        '    <skinsurface name="concentrator_skin" '
        'surfaceproperty="concentrator">\n'
        '      <volumeref ref="pmt_conc_log"/>\n    </skinsurface>\n',
        '  </structure>\n  <setup name="Default" version="1.0">\n'
        '    <world ref="world_log"/>\n  </setup>\n</gdml>\n']
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w') as f:
        f.write(''.join(out))
    ratdb = path + '.ratdb.json'
    with open(ratdb, 'w') as f:
        json.dump([
            {'name': 'GEO', 'index': 'pmt', 'valid_begin': 0, 'valid_end': 0,
             'type': 'pmtarray', 'pos_table': 'PMTINFO'},
            {'name': 'PMTINFO', 'index': '', 'valid_begin': 0,
             'valid_end': 0, 'x': pos[:, 0].tolist(),
             'y': pos[:, 1].tolist(), 'z': pos[:, 2].tolist(),
             'type': [1] * npmt}], f)
    return path, ratdb


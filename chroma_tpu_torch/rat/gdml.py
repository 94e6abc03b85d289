"""GDML parsing + solid meshing + optical property conversion (the
port's copy of chroma_tpu/rat/gdml.py).

Role parity with the reference GDML layer (reference:
chroma/rat/gdml.py), with one architectural difference: the reference
meshes solids through the gmsh OCC CSG kernel; here the common GDML
primitives (box, tube, sphere, orb, polycone, polyhedra, torus,
eltube, ellipsoid, tessellated) are meshed directly with the
framework's own revolve/extrude generators, and boolean solids require
gmsh (optional dependency) — a clear error is raised otherwise.

GDML optical property matrices are tabulated against photon energy
(MeV); `_convert_to_wavelength` flips them onto the wavelength grid.
"""
from copy import deepcopy

import numpy as np

from chroma_tpu_torch.geometry import (Surface, Material, Mesh,
                                       DichroicProps, standard_wavelengths)
from chroma_tpu_torch import make
from chroma_tpu_torch.log import logger

units = {'cm': 10, 'mm': 1, 'm': 1000, 'um': 1e-3, 'nm': 1e-6,
         'deg': np.pi / 180, 'rad': 1, 'g/cm3': 1}

# 2*pi*hbar*c in MeV*nm: E[MeV] = TWO_PI_HBARC / lambda[nm]
TWO_PI_HBARC = 2 * np.pi * 197.3269804e-6


def get_val(elem, attr, default=None):
    txt = elem.get(attr, default=None)
    assert txt is not None or default is not None, \
        'Missing attribute: ' + attr
    return eval(txt, {}, {}) if txt is not None else default


def get_vals(elem, value_attr=None, default_vals=None, unit_attr='unit'):
    if value_attr is None:
        value_attr = ['x', 'y', 'z']
    if default_vals is None:
        default_vals = [None] * len(value_attr)
    scale = units[elem.get(unit_attr)] if unit_attr is not None else 1.0
    return [get_val(elem, attr, default) * scale
            for attr, default in zip(value_attr, default_vals)]


def get_matrix(elem):
    assert elem.tag == 'matrix', 'Element is not a matrix'
    coldim = int(elem.get('coldim'))
    return get_vector(elem).reshape(-1, coldim)


def get_vector(elem, attr='values', dtype=float):
    return np.asarray(elem.get(attr).split(), dtype=dtype)


def get_zplanes(elem, tag='zplane', unit_attr='lunit'):
    scale = units[elem.get(unit_attr)] if unit_attr is not None else 1.0
    planes = deepcopy([p.attrib for p in elem.findall(tag)])
    for p in planes:
        p.update((k, float(v) * scale) for k, v in p.items())
        p.setdefault('rmin', 0.0)
    return planes


# ---------------------------------------------------------------------
# solid meshing (native revolve/extrude instead of gmsh CSG)
# ---------------------------------------------------------------------

def _revolve_z(r, z, nsteps=64, startphi=0.0, deltaphi=2 * np.pi):
    """Revolve an (r, z) profile about the z axis.

    Full revolutions reuse make.rotate_extrude (which revolves about
    y); the result is rotated so the GDML z axis is the symmetry axis.
    Partial revolutions are meshed directly with end caps.
    """
    r = np.asarray(r, float)
    z = np.asarray(z, float)
    if abs(deltaphi - 2 * np.pi) < 1e-9:
        mesh = make.rotate_extrude(r, z, nsteps)
        # rotate_extrude revolves about y: swap y <-> z (and negate x
        # to keep the orientation right-handed)
        v = mesh.vertices.copy()
        mesh.vertices = np.column_stack([-v[:, 0], v[:, 2], v[:, 1]])
        return mesh
    # partial revolution: grid of profile x angular steps + caps
    phis = np.linspace(startphi, startphi + deltaphi, nsteps + 1)
    prof = np.column_stack([r, z])
    rings = [np.column_stack([prof[:, 0] * np.cos(p),
                              prof[:, 0] * np.sin(p),
                              prof[:, 1]]) for p in phis]
    verts = np.concatenate(rings)
    npts = len(prof)
    tris = []
    for i in range(nsteps):
        a = np.arange(npts - 1) + i * npts
        b = a + npts
        tris.append(np.column_stack([a, a + 1, b + 1]))
        tris.append(np.column_stack([a, b + 1, b]))
    # end caps: fan from profile centroid
    for ring, flip in ((0, True), (nsteps, False)):
        base = ring * npts
        center = len(verts)
        verts = np.concatenate([verts, [verts[base:base + npts].mean(0)]])
        a = base + np.arange(npts - 1)
        cap = np.column_stack([np.full(npts - 1, center), a, a + 1])
        if flip:
            cap = cap[:, ::-1]
        tris.append(cap)
    return Mesh(verts, np.concatenate(tris), remove_duplicate_vertices=True)


def box(elem):
    x, y, z = get_vals(elem, ['x', 'y', 'z'], unit_attr='lunit')
    return make.box(x, y, z)


def tube(elem):
    rmin = get_val(elem, 'rmin', 0.0)
    rmax, z = get_vals(elem, ['rmax', 'z'], unit_attr='lunit')
    rmin *= units[elem.get('lunit')]
    startphi = get_val(elem, 'startphi', 0.0)
    deltaphi = get_val(elem, 'deltaphi', 2 * np.pi)
    aunit = elem.get('aunit')
    if aunit:
        startphi *= units[aunit]
        deltaphi *= units[aunit]
    if rmin > 0:
        r = [rmin, rmax, rmax, rmin, rmin]
        zz = [-z / 2, -z / 2, z / 2, z / 2, -z / 2]
    else:
        r = [0, rmax, rmax, 0]
        zz = [-z / 2, -z / 2, z / 2, z / 2]
    return _revolve_z(r, zz, startphi=startphi, deltaphi=deltaphi)


def sphere(elem):
    rmin = get_val(elem, 'rmin', 0.0) * units[elem.get('lunit')]
    rmax = get_val(elem, 'rmax') * units[elem.get('lunit')]
    aunit = elem.get('aunit')
    ascale = units[aunit] if aunit else 1.0
    starttheta = get_val(elem, 'starttheta', 0.0) * ascale
    deltatheta = get_val(elem, 'deltatheta', np.pi / ascale) * ascale
    startphi = get_val(elem, 'startphi', 0.0) * ascale
    deltaphi = get_val(elem, 'deltaphi', 2 * np.pi / ascale) * ascale
    thetas = np.linspace(starttheta, starttheta + deltatheta, 32)
    # outer arc (and inner arc if hollow), profile in (r, z)
    r_out = rmax * np.sin(thetas)
    z_out = rmax * np.cos(thetas)
    if rmin > 0:
        r_in = rmin * np.sin(thetas)[::-1]
        z_in = rmin * np.cos(thetas)[::-1]
        r = np.concatenate([r_out, r_in, r_out[:1]])
        z = np.concatenate([z_out, z_in, z_out[:1]])
    else:
        r = np.concatenate([[0], r_out, [0]])
        z = np.concatenate([[rmax], z_out, [-rmax if
                                            deltatheta >= np.pi - 1e-9
                                            else z_out[-1]]])
    return _revolve_z(r, z, startphi=startphi, deltaphi=deltaphi)


def orb(elem):
    r = get_val(elem, 'r') * units[elem.get('lunit')]
    mesh = make.sphere(r, nsteps=48)
    return mesh


def ellipsoid(elem):
    ax, by, cz = get_vals(elem, ['ax', 'by', 'cz'], unit_attr='lunit')
    mesh = make.sphere(1.0, nsteps=32)
    mesh.vertices = mesh.vertices * np.array([ax, by, cz])
    return mesh


def eltube(elem):
    dx, dy, dz = get_vals(elem, ['dx', 'dy', 'dz'], unit_attr='lunit')
    ang = np.linspace(0, 2 * np.pi, 48, endpoint=False)
    return make.linear_extrude(dx * np.cos(ang), dy * np.sin(ang), 2 * dz)


def polycone(elem):
    planes = get_zplanes(elem)
    planes.sort(key=lambda p: p['z'])
    r_out = [p['rmax'] for p in planes]
    z_out = [p['z'] for p in planes]
    r_in = [p['rmin'] for p in planes]
    hollow = any(np.asarray(r_in) > 0)
    if hollow:
        r = r_out + r_in[::-1] + r_out[:1]
        z = z_out + z_out[::-1] + z_out[:1]
    else:
        r = [0] + r_out + [0]
        z = [z_out[0]] + z_out + [z_out[-1]]
    return _revolve_z(r, z)


def polyhedra(elem):
    numsides = int(get_val(elem, 'numsides'))
    planes = get_zplanes(elem)
    planes.sort(key=lambda p: p['z'])
    # prism with `numsides` flats: like polycone but with numsides steps
    # and radii scaled so flats (not corners) sit at rmax
    scale = 1.0 / np.cos(np.pi / numsides)
    r_out = [p['rmax'] * scale for p in planes]
    z_out = [p['z'] for p in planes]
    r = [0] + r_out + [0]
    z = [z_out[0]] + z_out + [z_out[-1]]
    return _revolve_z(r, z, nsteps=numsides)


def torus(elem):
    rmin = get_val(elem, 'rmin', 0.0) * units[elem.get('lunit')]
    rmax = get_val(elem, 'rmax') * units[elem.get('lunit')]
    rtor = get_val(elem, 'rtor') * units[elem.get('lunit')]
    ang = np.linspace(0, 2 * np.pi, 32)
    return _revolve_z(rmax * np.cos(ang) + rtor, rmax * np.sin(ang))


def torusstack(elem):
    """RAT's custom torus-stack solid: stacked toroidal arcs defined by
    (z, rho) edge pairs with per-segment rotation origins."""
    z_edges = get_vector(elem, 'zEdge')
    rho_edges = get_vector(elem, 'rhoEdge')
    scale = units[elem.get('lunit', 'mm')]
    r = rho_edges * scale
    z = z_edges * scale
    order = np.argsort(z)
    prof_r = np.concatenate([[0], r[order], [0]])
    prof_z = np.concatenate([[z.min()], z[order], [z.max()]])
    return _revolve_z(prof_r, prof_z)


def tessellated(elem, vertex_positions):
    """Direct tessellated solid from named vertex references."""
    faces = []
    for t in elem:
        if t.tag == 'triangular':
            names = [t.get('vertex1'), t.get('vertex2'), t.get('vertex3')]
            faces.append([vertex_positions[n] for n in names])
        elif t.tag == 'quadrangular':
            names = [t.get('vertex1'), t.get('vertex2'), t.get('vertex3'),
                     t.get('vertex4')]
            v = [vertex_positions[n] for n in names]
            faces.append([v[0], v[1], v[2]])
            faces.append([v[0], v[2], v[3]])
    verts = np.asarray(faces, float).reshape(-1, 3)
    tris = np.arange(len(verts)).reshape(-1, 3)
    return Mesh(verts, tris, remove_duplicate_vertices=True)


def opticalsurface(elem):
    return None


def unsupported(elem):
    raise NotImplementedError(
        'GDML solid type %r is not supported without gmsh' % elem.tag)


def ignore(elem):
    return None


# ---------------------------------------------------------------------
# optical property conversion (energy grid -> wavelength grid)
# ---------------------------------------------------------------------

def _convert_to_wavelength(arr, dy_dwavelength=False):
    arr = np.array(arr, dtype=float)
    arr[:, 0] = TWO_PI_HBARC / arr[:, 0]
    if dy_dwavelength:
        arr[:, 1] *= TWO_PI_HBARC / (arr[:, 0] ** 2)
    return arr[::-1]


def _pdf_to_cdf(arr):
    x, y = arr.T
    yc = np.cumsum((y[1:] + y[:-1]) * (x[1:] - x[:-1]))
    yc = np.concatenate([[0], yc])
    if yc[-1] != 0:
        yc /= yc[-1]
    return np.column_stack([x, yc])


def _exp_decay_cdf(arr, t_rise=0):
    decays = np.exp(-arr[:, 0])
    weights = np.exp(arr[:, 1])
    max_time = 3.0 * np.max(decays)
    min_time = np.min(decays)
    bin_width = min_time / 100
    times = np.arange(0, max_time + bin_width / 2, bin_width)
    if t_rise == 0:
        cdf = np.sum([a * (t * (1.0 - np.exp(-times / t))) / t
                      for t, a in zip(decays, weights)], axis=0)
    else:
        cdf = np.sum([a * (t * (1.0 - np.exp(-times / t))
                           + t_rise * (np.exp(-times / t_rise) - 1))
                      / (t - t_rise) for t, a in zip(decays, weights)],
                     axis=0)
    return np.column_stack([times, cdf])


def _find_property(matrix_map, prop_name, properties):
    for prop in properties:
        if prop.get('name') == prop_name:
            return get_matrix(matrix_map[prop.get('ref')])
    return None


def create_material(matrix_map, material_xml):
    """chroma Material from a GDML <material> element (reference:
    chroma/rat/gdml.py:282)."""
    name = material_xml.get('name')
    material = Material(name)
    d_elem = material_xml.find('D')
    if d_elem is not None:
        material.density = get_val(d_elem, 'value') \
            * units.get(d_elem.get('unit'), 1.0)
    material.set('refractive_index', 1.0)
    material.set('absorption_length', 1e6)
    material.set('scattering_length', 1e6)
    for comp in material_xml.findall('fraction'):
        material.composition[comp.get('ref').split('0x')[0]] = \
            get_val(comp, 'n')

    num_comp = 0
    optical_props = material_xml.findall('property')
    for prop in optical_props:
        data = get_matrix(matrix_map[prop.get('ref')])
        pname = prop.get('name')
        if pname == 'RINDEX':
            material.refractive_index = _convert_to_wavelength(data)
        elif pname == 'ABSLENGTH':
            material.absorption_length = _convert_to_wavelength(data)
        elif pname == 'RSLENGTH':
            material.scattering_length = _convert_to_wavelength(data)
        elif pname == 'SCINTILLATION':
            material.scintillation_spectrum = \
                _convert_to_wavelength(data, dy_dwavelength=True)
        elif pname == 'SCINT_RISE_TIME':
            material.scintillation_rise_time = data.item()
        elif pname == 'LIGHT_YIELD':
            material.scintillation_light_yield = data.item()
        elif pname.startswith('SCINTWAVEFORM'):
            material.scintillation_waveform = \
                material.scintillation_waveform or {}
            material.scintillation_waveform[
                pname[len('SCINTWAVEFORM'):]] = data
        elif pname.startswith('SCINTMOD'):
            material.scintillation_mod = material.scintillation_mod or {}
            material.scintillation_mod[pname[len('SCINTMOD'):]] = data
        elif pname == 'NUM_COMP':
            num_comp = int(data.item())

    if num_comp > 0:
        reemission_spectrum = None
        for pname in ('SCINTILLATION_WLS', 'SCINTILLATION'):
            spec = _find_property(matrix_map, pname, optical_props)
            if spec is not None:
                reemission_spectrum = _pdf_to_cdf(
                    _convert_to_wavelength(spec, dy_dwavelength=True))
                break
        assert reemission_spectrum is not None, \
            'No reemission spectrum found for material %s' % name
        for i in range(num_comp):
            prob = _find_property(matrix_map, 'REEMISSION_PROB%d' % i,
                                  optical_props)
            if prob is not None:
                prob = _convert_to_wavelength(prob)
            else:
                prob = np.column_stack(
                    (standard_wavelengths,
                     np.zeros(standard_wavelengths.size)))
            waveform = _find_property(matrix_map, 'REEMITWAVEFORM%d' % i,
                                      optical_props)
            if waveform is not None:
                if waveform.flatten()[0] < 0:
                    waveform = _exp_decay_cdf(waveform)
                else:
                    waveform = _pdf_to_cdf(waveform)
            else:
                waveform = np.column_stack(([0, 1], [0, 0]))
            abslen = _find_property(matrix_map, 'ABSLENGTH%d' % i,
                                    optical_props)
            assert abslen is not None, \
                'No component-wise absorption length for %s' % name
            material.comp_reemission_prob.append(prob)
            material.comp_reemission_wvl_cdf.append(reemission_spectrum)
            material.comp_reemission_time_cdf.append(waveform)
            material.comp_absorption_length.append(
                _convert_to_wavelength(abslen))
    return material


# Geant4's GDML writer emits enum *names*; RAT-exported GDML emits the
# numeric values the reference parser expects (chroma/rat/gdml.py:215).
# Accept both.
_SURFACE_ENUMS = {
    'model': {'glisur': 0, 'unified': 1, 'LUT': 2, 'DAVIS': 3,
              'dichroic': 4},
    'type': {'dielectric_metal': 0, 'dielectric_dielectric': 1,
             'dielectric_LUT': 2, 'dielectric_LUTDAVIS': 3,
             'dichroic': 4, 'firsov': 5, 'x_ray': 6},
    'finish': {'polished': 0, 'polishedfrontpainted': 1,
               'polishedbackpainted': 2, 'ground': 3,
               'groundfrontpainted': 4, 'groundbackpainted': 5},
}


def _surface_enum(surface_xml, attr):
    raw = surface_xml.get(attr)
    if raw in _SURFACE_ENUMS[attr]:
        return _SURFACE_ENUMS[attr][raw]
    return get_val(surface_xml, attr=attr)


def create_surface(matrix_map, surface_xml):
    """chroma Surface from a GDML <opticalsurface> element (reference:
    chroma/rat/gdml.py:215)."""
    name = surface_xml.get('name')
    surface = Surface(name)
    model = _surface_enum(surface_xml, 'model')
    surface_type = _surface_enum(surface_xml, 'type')
    finish = _surface_enum(surface_xml, 'finish')
    value = get_val(surface_xml, attr='value')
    assert model in (0, 1, 4), \
        'Only glisur, unified, and dichroic models are supported'
    assert surface_type in (0, 4), \
        'Only dielectric_metal and dichroic surfaces are supported'
    assert finish in (0, 1, 3), \
        'Only polished, ground, and polishedfrontpainted are supported'
    specular_component = value if model == 0 else 1 - value
    surface.transmissive = 0 if finish == 1 else 1

    abslength = None
    for prop in surface_xml.findall('property'):
        data = get_matrix(matrix_map[prop.get('ref')])
        pname = prop.get('name')
        if pname == 'REFLECTIVITY':
            reflectivity = _convert_to_wavelength(data)
            spec = reflectivity.copy()
            spec[:, 1] *= specular_component
            diff = reflectivity.copy()
            diff[:, 1] *= (1 - specular_component)
            surface.reflect_specular = spec
            surface.reflect_diffuse = diff
        elif pname == 'THICKNESS':
            thicknesses = data[:, 1]
            if not np.allclose(thicknesses, thicknesses[0]):
                logger.warning('Surface %s has non-uniform thicknesses; '
                               'averaging', name)
            surface.thickness = float(np.mean(thicknesses))
        elif pname == 'RINDEX':
            surface.eta = _convert_to_wavelength(data)
        elif pname == 'KINDEX':
            surface.k = _convert_to_wavelength(data)
            surface.model = 1  # complex thin-film model
        elif pname == 'EFFICIENCY':
            surface.detect = _convert_to_wavelength(data)
        elif pname == 'ABSLENGTH':
            abslength = _convert_to_wavelength(data)
    if abslength is not None:
        surface.absorb = abslength
        surface.absorb[:, 1] = 1 - np.exp(-surface.thickness
                                          / surface.absorb[:, 1])

    if model == 4 and surface_type == 4:
        dichroic_data = surface_xml.find('dichroic_data')
        assert dichroic_data is not None, \
            'Dichroic surfaces must have dichroic_data'
        surface.model = 3
        x_length = get_val(dichroic_data, attr='x_length')
        y_length = get_val(dichroic_data, attr='y_length')
        wvls = get_vector(dichroic_data.find('x'))
        angles = np.deg2rad(get_vector(dichroic_data.find('y')))
        transmission = get_vector(dichroic_data.find('data')) \
            .reshape(x_length, y_length) / 100
        reflection = 1 - transmission
        transmits = [np.column_stack([wvls, transmission[:, i]])
                     for i in range(y_length)]
        reflects = [np.column_stack([wvls, reflection[:, i]])
                    for i in range(y_length)]
        surface.dichroic_props = DichroicProps(angles, reflect=reflects,
                                               transmit=transmits)
    return surface

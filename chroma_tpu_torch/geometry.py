"""Scene description: meshes, solids, optical materials/surfaces, geometry.

Same data model as the reference framework (reference: chroma/geometry.py):
a ``Geometry`` is a list of placed ``Solid``s; ``flatten()`` produces one
flat triangle soup plus per-triangle index arrays (inner/outer material,
surface, solid id, color) that the port packs into device tables
(chroma_tpu_torch/ops/geometry_pack.py).  A copy of chroma_tpu/geometry.py,
fully vectorized (no per-triangle Python loops).
"""
from hashlib import md5 as _md5

import numpy as np

from chroma_tpu_torch.log import logger

# All wavelength-dependent material/surface properties are linearly
# resampled onto this uniform grid before being shipped to the device
# (reference: chroma/geometry.py:17).  Linear interpolation guarantees
# that sets of probabilities that sum to 1 still sum to 1 after
# resampling, which the surface-interaction sampler relies on.
standard_wavelengths = np.arange(60, 1000, 5).astype(np.float32)


class Mesh(object):
    """Indexed triangle mesh: float32 vertices (V,3), int32 triangles (T,3).

    (reference: chroma/geometry.py:19)
    """

    def __init__(self, vertices, triangles, remove_duplicate_vertices=False,
                 round=True, remove_null_triangles=True):
        vertices = np.asarray(vertices, dtype=np.float32)
        triangles = np.asarray(triangles, dtype=np.int32)

        if vertices.ndim != 2 or vertices.shape[1] != 3:
            raise ValueError('shape mismatch')
        if triangles.ndim != 2 or triangles.shape[1] != 3:
            raise ValueError('shape mismatch')
        if (triangles < 0).any():
            raise ValueError('indices in `triangles` must be positive.')
        if (triangles >= len(vertices)).any():
            raise ValueError('indices in `triangles` must be less than the '
                             'length of the vertex array.')

        self.vertices = vertices
        self.triangles = triangles
        if len(self.vertices) == 0:
            logger.warning('Generated mesh has no vertices.')
        if len(self.triangles) == 0:
            logger.warning('Generated mesh has no triangles.')
        if round:
            self.vertices = self.vertices.round(decimals=12)
        if remove_duplicate_vertices:
            self.remove_duplicate_vertices()
        if remove_null_triangles:
            self.remove_null_triangles()

    def get_triangle_centers(self):
        """(T,3) centroid of each triangle."""
        return np.mean(self.assemble(), axis=1)

    def get_bounds(self):
        """(lower, upper) corners of the axis-aligned mesh bounding box."""
        return np.min(self.vertices, axis=0), np.max(self.vertices, axis=0)

    def remove_duplicate_vertices(self):
        """Merge identical vertices and remap triangle indices."""
        record = self.vertices.view([('', self.vertices.dtype)] * 3)
        unique, inverse = np.unique(record, return_inverse=True)
        self.vertices = unique.view(self.vertices.dtype).reshape(-1, 3)
        self.triangles = inverse.reshape(-1)[self.triangles.ravel()] \
            .reshape(-1, 3).astype(np.int32)

    def remove_null_triangles(self):
        """Drop degenerate triangles (repeated vertex index).

        Returns the boolean mask of retained triangles so callers can
        filter per-triangle property arrays in step.
        """
        if len(self.triangles) == 0:
            return
        t = self.triangles
        mask = (t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2]) & (t[:, 0] != t[:, 2])
        self.triangles = t[mask]
        return mask

    def assemble(self, key=slice(None), group=True):
        """Vertex positions of every triangle: (T,3,3) if ``group`` else
        flat (3T,3)."""
        idx = self.triangles[key]
        if not group:
            idx = idx.flatten()
        return self.vertices[idx]

    def __add__(self, other):
        return Mesh(np.concatenate((self.vertices, other.vertices)),
                    np.concatenate((self.triangles,
                                    other.triangles + len(self.vertices))))

    def __len__(self):
        return len(self.triangles)

    def md5(self):
        """Hex digest of vertices+triangles; the BVH cache key."""
        checksum = _md5(np.ascontiguousarray(self.vertices))
        checksum.update(np.ascontiguousarray(self.triangles))
        return checksum.hexdigest()


def _unique_objects(seq):
    """Order-stable unique list of (hashable) objects."""
    seen, out = set(), []
    for x in seq:
        if x not in seen:
            seen.add(x)
            out.append(x)
    return out


def _per_triangle(value, ntriangles, dtype=object):
    """Broadcast a scalar-or-sequence property to one entry per triangle."""
    if np.iterable(value):
        if len(value) != ntriangles:
            raise ValueError('shape mismatch')
        return np.array(value, dtype=dtype)
    arr = np.empty(ntriangles, dtype=dtype)
    arr[:] = value
    return arr


class Solid(object):
    """A Mesh with per-triangle inner/outer material, surface and color.

    (reference: chroma/geometry.py:115)
    """

    def __init__(self, mesh, inner_material=None, outer_material=None,
                 surface=None, color=0x33ffffff):
        self.mesh = mesh
        nt = len(mesh.triangles)
        self.inner_material = _per_triangle(inner_material, nt)
        self.outer_material = _per_triangle(outer_material, nt)
        self.surface = _per_triangle(surface, nt)
        if np.iterable(color):
            if len(color) != nt:
                raise ValueError('shape mismatch')
            self.color = np.array(color, dtype=np.uint32)
        else:
            self.color = np.full(nt, color, dtype=np.uint32)

        self.unique_materials = _unique_objects(
            list(self.inner_material) + list(self.outer_material))
        self.unique_surfaces = _unique_objects(list(self.surface))

    def __add__(self, other):
        combined = Solid(self.mesh + other.mesh)
        for field in ('inner_material', 'outer_material', 'surface', 'color'):
            setattr(combined, field,
                    np.concatenate((getattr(self, field),
                                    getattr(other, field))))
        combined.unique_materials = _unique_objects(
            self.unique_materials + other.unique_materials)
        combined.unique_surfaces = _unique_objects(
            self.unique_surfaces + other.unique_surfaces)
        return combined

    def weld(self, other, shared_triangle_surface=None,
             shared_triangle_color=None):
        """Merge ``other`` into this solid, collapsing identical triangles.

        Triangles present in both (same three vertex positions in any
        order) are kept once, with this solid's surface/color unless
        overridden.  Not a boolean union.  (reference:
        chroma/geometry.py:166)
        """
        keys_self = [frozenset(map(tuple, tri))
                     for tri in self.mesh.vertices[self.mesh.triangles]]
        keys_other = [frozenset(map(tuple, tri))
                      for tri in other.mesh.vertices[other.mesh.triangles]]
        self_set = set(keys_self)
        dup_mask = np.array([k in self_set for k in keys_other], dtype=bool)
        if not dup_mask.any():
            raise Exception('cannot weld solids with no shared triangles')
        shared_in_self = np.array([k in set(keys_other) for k in keys_self],
                                  dtype=bool)

        keep = ~dup_mask
        mesh = Mesh(other.mesh.vertices, other.mesh.triangles[keep])
        self.mesh = self.mesh + mesh
        self.inner_material = np.concatenate(
            (self.inner_material, other.inner_material[keep]))
        self.outer_material = np.concatenate(
            (self.outer_material, other.outer_material[keep]))
        self.surface = np.concatenate((self.surface, other.surface[keep]))
        self.color = np.concatenate((self.color, other.color[keep]))

        # at the shared boundary, our triangles now face other's interior
        self.outer_material[shared_in_self] = other.inner_material[0]
        if shared_triangle_surface is not None:
            self.surface[shared_in_self] = shared_triangle_surface
        if shared_triangle_color is not None:
            self.color[shared_in_self] = shared_triangle_color

    def material_indices(self, lookup, which='inner'):
        src = self.inner_material if which == 'inner' else self.outer_material
        return np.fromiter((lookup[m] for m in src), dtype=np.int32,
                           count=len(src))

    def surface_indices(self, lookup):
        return np.fromiter((lookup[s] for s in self.surface), dtype=np.int32,
                           count=len(self.surface))


class _WavelengthProperty(object):
    """Mixin: properties stored as (n,2) arrays of (wavelength, value)."""

    def set(self, name, value, wavelengths=standard_wavelengths):
        if np.iterable(value):
            if len(value) != len(wavelengths):
                raise ValueError('shape mismatch')
            value = np.asarray(value, dtype=np.float32)
        else:
            value = np.full(len(wavelengths), value, dtype=np.float32)
        self.__dict__[name] = np.column_stack(
            (np.asarray(wavelengths, dtype=np.float32), value))


class Material(_WavelengthProperty):
    """Bulk optical properties of a medium (reference: chroma/geometry.py:221).

    Wavelength-dependent tables: refractive_index, absorption_length (mm),
    scattering_length (mm).  Scintillating / wavelength-shifting media add
    per-component reemission tables: comp_reemission_prob (wavelength),
    comp_reemission_wvl_cdf (wavelength CDF), comp_reemission_time_cdf
    (time CDF), comp_absorption_length.
    """

    def __init__(self, name='none'):
        self.name = name
        self.refractive_index = None
        self.absorption_length = None
        self.scattering_length = None
        self.scintillation_spectrum = None
        self.scintillation_light_yield = None
        self.scintillation_rise_time = None
        self.scintillation_waveform = None
        self.scintillation_mod = None
        self.comp_reemission_prob = []
        self.comp_reemission_wvl_cdf = []
        self.comp_reemission_times = []
        self.comp_reemission_time_cdf = []
        self.comp_absorption_length = []
        self.density = 0.0      # g/cm^3
        self.composition = {}   # fraction by mass

    def add_reemission_component(self, reemission_prob, wvl_cdf,
                                 time_cdf=None, absorption_length=None):
        """Register one scintillation/WLS component.

        Each argument is an (n,2) array of (wavelength-or-time, value):
        ``reemission_prob`` the reemit-given-absorbed probability,
        ``wvl_cdf`` the reemission wavelength CDF, ``time_cdf`` the
        reemission time-delay CDF (default: prompt), and
        ``absorption_length`` the component's partial absorption length
        (default: the material's total absorption length).
        """
        if time_cdf is None:
            time_cdf = np.array([[0.0, 0.0], [1e-4, 1.0]])
        if absorption_length is None:
            absorption_length = self.absorption_length
        self.comp_reemission_prob.append(
            np.asarray(reemission_prob, dtype=np.float32))
        self.comp_reemission_wvl_cdf.append(
            np.asarray(wvl_cdf, dtype=np.float32))
        self.comp_reemission_time_cdf.append(
            np.asarray(time_cdf, dtype=np.float32))
        self.comp_absorption_length.append(
            np.asarray(absorption_length, dtype=np.float32))

    def __repr__(self):
        return '<Material %s>' % self.name


# The canonical empty material.
vacuum = Material('vacuum')
vacuum.set('refractive_index', 1.0)
vacuum.set('absorption_length', 1e6)
vacuum.set('scattering_length', 1e6)


class DichroicProps(object):
    """Angle x wavelength reflect/transmit tables for dichroic films
    (reference: chroma/geometry.py:257)."""

    def __init__(self, angles, reflect, transmit):
        self.angles = np.asarray(angles)                 # [angle]
        self.dichroic_reflect = np.asarray(reflect)      # [angle][point,2]
        self.dichroic_transmit = np.asarray(transmit)    # [angle][point,2]


# Surface interaction models (device ABI; reference:
# chroma/cuda/geometry_types.h:22)
SURFACE_DEFAULT = 0
SURFACE_COMPLEX = 1
SURFACE_WLS = 2
SURFACE_DICHROIC = 3


class Surface(_WavelengthProperty):
    """Optical properties of a triangle surface (reference:
    chroma/geometry.py:263).

    model selects the interaction: SURFACE_DEFAULT (detect/absorb/
    diffuse/specular by linearly-interpolated probabilities),
    SURFACE_COMPLEX (thin film with complex refractive index eta+ik),
    SURFACE_WLS (surface wavelength shifter), SURFACE_DICHROIC.
    """

    def __init__(self, name='none', model=SURFACE_DEFAULT):
        self.name = name
        self.model = model

        self.set('detect', 0)
        self.set('absorb', 0)
        self.set('reemit', 0)
        self.set('reflect_diffuse', 0)
        self.set('reflect_specular', 0)
        self.set('eta', 0)
        self.set('k', 0)
        self.set('reemission_cdf', 0)

        self.dichroic_props = None
        self.thickness = 0.0
        self.transmissive = 0

    def set(self, name, value, wavelengths=standard_wavelengths):
        negative = ((np.asarray(value) < 0.0).any() if np.iterable(value)
                    else value < 0.0)
        if negative:
            raise Exception('all probabilities must be >= 0.0')
        _WavelengthProperty.set(self, name, value, wavelengths)

    def __repr__(self):
        return '<Surface %s>' % self.name


class Geometry(object):
    """A scene: placed solids + the medium the detector sits in.

    (reference: chroma/geometry.py:297)
    """

    def __init__(self, detector_material=None):
        self.detector_material = detector_material
        self.solids = []
        self.solid_rotations = []
        self.solid_displacements = []
        self.bvh = None

    def add_solid(self, solid, rotation=None, displacement=None):
        """Place ``solid`` with the given rotation matrix and displacement.
        Returns the solid id."""
        if rotation is None:
            rotation = np.identity(3)
        rotation = np.asarray(rotation, dtype=np.float32)
        if rotation.shape != (3, 3):
            raise ValueError('rotation matrix has the wrong shape.')
        if displacement is None:
            displacement = np.zeros(3)
        displacement = np.asarray(displacement, dtype=np.float32)
        if displacement.shape != (3,):
            raise ValueError('displacement vector has the wrong shape.')

        self.solid_rotations.append(rotation)
        self.solid_displacements.append(displacement)
        self.solids.append(solid)
        return len(self.solids) - 1

    def flatten(self):
        """Bake all placed solids into one flat mesh + per-triangle arrays.

        Produces: self.mesh, self.colors (T,), self.solid_id (T,),
        self.unique_materials / unique_surfaces,
        self.inner_material_index / outer_material_index / surface_index
        (T,) int32, with surface_index == -1 for "no surface".
        (reference: chroma/geometry.py:337)
        """
        if hasattr(self, 'mesh'):
            return

        nv = np.cumsum([0] + [len(s.mesh.vertices) for s in self.solids])
        nt = np.cumsum([0] + [len(s.mesh.triangles) for s in self.solids])

        vertices = np.empty((nv[-1], 3), dtype=np.float32)
        triangles = np.empty((nt[-1], 3), dtype=np.int32)

        logger.info('Flattening detector mesh...')
        logger.info('  triangles: %d' % len(triangles))
        logger.info('  vertices:  %d' % len(vertices))

        for i, solid in enumerate(self.solids):
            vertices[nv[i]:nv[i + 1]] = \
                solid.mesh.vertices @ self.solid_rotations[i].T \
                + self.solid_displacements[i]
            triangles[nt[i]:nt[i + 1]] = solid.mesh.triangles + nv[i]

        # distinct solids rarely share vertices, so dedup after stacking
        self.mesh = Mesh(vertices, triangles, remove_duplicate_vertices=True,
                         remove_null_triangles=False)

        self.colors = np.concatenate([s.color for s in self.solids])
        self.solid_id = np.concatenate(
            [np.full(len(s.mesh.triangles), i, dtype=np.uint32)
             for i, s in enumerate(self.solids)])

        self.unique_materials = _unique_objects(
            [m for s in self.solids for m in s.unique_materials])
        material_lookup = {m: i for i, m in enumerate(self.unique_materials)}
        self.inner_material_index = np.concatenate(
            [s.material_indices(material_lookup, 'inner')
             for s in self.solids])
        self.outer_material_index = np.concatenate(
            [s.material_indices(material_lookup, 'outer')
             for s in self.solids])

        self.unique_surfaces = _unique_objects(
            [x for s in self.solids for x in s.unique_surfaces])
        surface_lookup = {s: i for i, s in enumerate(self.unique_surfaces)}
        self.surface_index = np.concatenate(
            [s.surface_indices(surface_lookup) for s in self.solids])
        if None in surface_lookup:
            self.surface_index[self.surface_index == surface_lookup[None]] = -1

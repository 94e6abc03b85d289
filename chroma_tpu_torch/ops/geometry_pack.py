"""Pack a flattened Geometry/Detector into device tables of torch tensors.

Counterpart of chroma_tpu/ops/geometry_pack.py.  The packing is numpy,
with the port's own copy of the MBVH builder (bvh/mbvh.py), so both
packages build identical tables; only the final upload differs.
uint32 tables (material codes, colors, MBVH rows) are held as int32
tensors with the same bits, because torch has no unsigned right shift
on the CPU: every consumer masks after each shift.

The escape-rope walker's tables (``nodes``, ``escape`` from
``compute_escape_pointers``, ``tri_vertices``; ops/mesh.py) are packed
for meshes that carry a BVH of at most ``LEGACY_WALKER_MAX_TRIANGLES``
triangles, else one-row placeholders, as in the JAX package.
"""
import dataclasses
import hashlib
import os

import numpy as np
import torch

from chroma_tpu_torch.bvh.build import _intra_run
from chroma_tpu_torch.bvh.bvh import from_uint4
from chroma_tpu_torch.device import resolve
from chroma_tpu_torch.geometry import standard_wavelengths

DEFAULT_TIME_GRID = np.arange(0.0, 1000.0, 0.05, dtype=np.float32)
N_ICDF = 2048
_UGRID = np.linspace(0.0, 1.0, N_ICDF).astype(np.float32)
INSTANCING_MIN_GAIN = 100_000       # duplicated triangles worth a TLAS

# JAX-package fields held as int32 here but stored as uint32 there
U32_FIELDS = ('material_codes', 'colors', 'mbvh_rows', 'nodes', 'escape')
# geometries beyond this triangle count ship only the MBVH: the
# escape-rope walker's tables would cost ~65 B a triangle and serve
# only as a second walker on small meshes
LEGACY_WALKER_MAX_TRIANGLES = 2_000_000
ESCAPE_SENTINEL = np.uint32(0xFFFFFFFF)
# the escape-rope walker's tables when they are not packed
LEGACY_PLACEHOLDERS = {
    'nodes': np.zeros((1, 4), np.uint32),
    'escape': np.zeros(1, np.uint32),
    'tri_vertices': np.zeros((1, 3, 3), np.float32),
}


def _static(default):
    return dataclasses.field(default=default, metadata={'static': True})


@dataclasses.dataclass
class GeometryTables:
    """Device-side geometry: tensors plus static grid parameters and
    capability flags (same names as the JAX package's GeometryTables)."""
    vertices: torch.Tensor            # (V,3) f32
    triangles: torch.Tensor           # (T,3) i32
    tri_vertices: torch.Tensor        # (T,3,3) f32, escape-rope walker
    material_codes: torch.Tensor      # (T,)  i32 (u32 bits)
    colors: torch.Tensor              # (T,)  i32 (u32 bits)
    solid_id_map: torch.Tensor        # (T,)  i32
    nodes: torch.Tensor               # (N,4) i32 (u32 bits), BVH nodes
    escape: torch.Tensor              # (N,)  i32 (u32 bits), ropes
    world_origin: torch.Tensor        # (3,)  f32 (MBVH world box)
    world_scale: torch.Tensor         # ()    f32
    legacy_world_origin: torch.Tensor  # (3,) f32
    legacy_world_scale: torch.Tensor   # ()   f32
    mbvh_rows: torch.Tensor           # (R, ROW_WIDTH) i32 (u32 bits)
    refractive_index: torch.Tensor    # (M,W)
    absorption_length: torch.Tensor   # (M,W)
    scattering_length: torch.Tensor   # (M,W)
    num_comp: torch.Tensor            # (M,) i32
    comp_reemission_prob: torch.Tensor      # (M,C,W)
    comp_reemission_wvl_cdf: torch.Tensor   # (M,C,W)
    comp_reemission_time_cdf: torch.Tensor  # (M,C,Tn)
    comp_absorption_length: torch.Tensor    # (M,C,W)
    surf_detect: torch.Tensor            # (S,W)
    surf_absorb: torch.Tensor            # (S,W)
    surf_reemit: torch.Tensor            # (S,W)
    surf_reflect_diffuse: torch.Tensor   # (S,W)
    surf_reflect_specular: torch.Tensor  # (S,W)
    surf_eta: torch.Tensor               # (S,W)
    surf_k: torch.Tensor                 # (S,W)
    surf_reemission_cdf: torch.Tensor    # (S,W)
    surf_model: torch.Tensor             # (S,) i32
    surf_transmissive: torch.Tensor      # (S,) i32
    surf_thickness: torch.Tensor         # (S,) f32
    dichroic_angles: torch.Tensor        # (S,A) f32
    dichroic_nangles: torch.Tensor       # (S,)  i32
    dichroic_reflect: torch.Tensor       # (S,A,W)
    dichroic_transmit: torch.Tensor      # (S,A,W)
    comp_reemission_wvl_icdf: torch.Tensor   # (M,C,NU)
    comp_reemission_time_icdf: torch.Tensor  # (M,C,NU)
    surf_reemission_icdf: torch.Tensor       # (S,NU)
    wavelength0: float = _static(60.0)
    wavelength_step: float = _static(5.0)
    nwavelengths: int = _static(188)
    time0: float = _static(0.0)
    time_step: float = _static(0.05)
    ntimes: int = _static(20000)
    mbvh_depth: int = _static(8)
    mbvh_instanced: bool = _static(False)
    nu: int = _static(2048)
    has_reemission: bool = _static(False)
    has_surfaces: bool = _static(False)
    has_complex: bool = _static(False)
    has_wls: bool = _static(False)
    has_dichroic: bool = _static(False)
    max_comp: int = _static(1)

    def to(self, device):
        return _to(self, device)


@dataclasses.dataclass
class DetectorTables:
    """Channel maps and shared readout inverse CDFs."""
    solid_id_to_channel_index: torch.Tensor  # (n_solids,) i32
    time_cdf_x: torch.Tensor                 # (Lt,) f32
    time_cdf_y: torch.Tensor                 # (Lt,) f32
    charge_cdf_x: torch.Tensor               # (Lq,) f32
    charge_cdf_y: torch.Tensor               # (Lq,) f32
    time_icdf: torch.Tensor                  # (NU,) f32
    charge_icdf: torch.Tensor                # (NU,) f32
    charge_unit: torch.Tensor                # ()    f32
    nchannels: int = _static(0)

    def to(self, device):
        return _to(self, device)


def static_fields(cls):
    return [f.name for f in dataclasses.fields(cls)
            if f.metadata.get('static')]


def array_fields(cls):
    return [f.name for f in dataclasses.fields(cls)
            if not f.metadata.get('static')]


def _to(tables, device):
    return dataclasses.replace(
        tables, **{k: getattr(tables, k).to(device)
                   for k in array_fields(type(tables))})


def _tensor(a, device):
    """numpy -> torch on ``device``; uint32 becomes int32 (same bits)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order='C')).to(device)


def tables_from_numpy(geom_arrays, det_arrays, static, device=None):
    """Tables from numpy arrays keyed by field name (for example
    ``np.asarray`` of every field of the JAX package's tables).  Fields
    the port does not carry are ignored.  ``static`` maps 'geom' and
    'det' to their static fields.  ``det_arrays`` may be None.
    ``device=None`` is the card (chroma_tpu_torch.device)."""
    device = resolve(device)
    geom = GeometryTables(
        **{k: _tensor(geom_arrays[k], device)
           for k in array_fields(GeometryTables)},
        **{k: static['geom'][k] for k in static_fields(GeometryTables)})
    det = None
    if det_arrays is not None:
        det = DetectorTables(
            **{k: _tensor(det_arrays[k], device)
               for k in array_fields(DetectorTables)},
            **{k: static['det'][k] for k in static_fields(DetectorTables)})
    return geom, det


def interp_material_property(wavelengths, prop):
    """Linearly resample a (n,2) (wavelength, value) table onto a grid
    (linear, so surface probabilities that sum to 1 still do)."""
    prop = np.asarray(prop)
    return np.interp(wavelengths, prop[:, 0], prop[:, 1]).astype(np.float32)


def inverse_cdf(cdf_x, cdf_y, ugrid=_UGRID):
    """Tabulate the inverse of a CDF on a uniform u-grid."""
    cdf_x = np.asarray(cdf_x, dtype=np.float64)
    cdf_y = np.asarray(cdf_y, dtype=np.float64)
    if cdf_y[-1] <= 0:
        return np.full(len(ugrid), cdf_x[0], dtype=np.float32)
    y = cdf_y / cdf_y[-1]
    return np.interp(ugrid, y, cdf_x).astype(np.float32)


def sample_icdf(icdf, u):
    """Draw from a tabulated 1-D inverse CDF at uniforms u in [0, 1)."""
    nu = icdf.shape[-1]
    x = u * (nu - 1)
    j = torch.clamp(torch.nan_to_num(x, nan=0.0), 0, nu - 2).to(torch.int64)
    f = x - j
    lo = icdf[j]
    return lo + (icdf[j + 1] - lo) * f


def _want_instancing(geometry, instancing):
    """Explicit argument, then CHROMA_TPU_INSTANCING, then auto."""
    from chroma_tpu_torch.bvh.mbvh import instancing_gain
    if instancing is None:
        env = os.environ.get('CHROMA_TPU_INSTANCING')
        if env is not None:
            instancing = env.lower() not in ('0', 'false', 'no')
    if instancing is None:
        return instancing_gain(geometry) >= INSTANCING_MIN_GAIN
    return bool(instancing)


def _load_or_build_mbvh(geometry, material_codes, instancing=None):
    """Build (or load from the port's BVH cache) the wide fat-row MBVH,
    under the same cache name as the JAX package."""
    from chroma_tpu_torch.bvh.mbvh import (build_mbvh, build_mbvh_instanced,
                                           BRANCH, ROW_WIDTH, LAYOUT_VERSION,
                                           TARGET_DEGREE, builder_tag)
    from chroma_tpu_torch.cache import Cache
    use_inst = _want_instancing(geometry, instancing)
    name = 'mbvh%d_%d_d%d_v%d_%s_%s' % (BRANCH, ROW_WIDTH, TARGET_DEGREE,
                                        LAYOUT_VERSION, builder_tag(),
                                        'i' if use_inst else 'f') \
        + hashlib.md5(np.ascontiguousarray(material_codes)).hexdigest()[:10]
    cache = Cache()
    mesh_hash = geometry.mesh.md5()
    if cache.exist_bvh(mesh_hash, name):
        return cache.load_bvh(mesh_hash, name)
    mbvh = build_mbvh_instanced(geometry, material_codes) if use_inst \
        else None
    if mbvh is None:
        mbvh = build_mbvh(geometry.mesh, material_codes=material_codes)
    cache.save_bvh(mbvh, mesh_hash, name)
    return mbvh


def _uniform_step(grid, what):
    step = (float(grid[-1]) - float(grid[0])) / (len(grid) - 1)
    if not np.allclose(np.diff(grid), step, rtol=1e-3,
                       atol=abs(step) * 1e-3):
        raise ValueError('%s must be equally spaced apart.' % what)
    return step


def compute_escape_pointers(nodes_arr):
    """Escape ("rope") pointer of every BVH node, uint32: the node a
    depth-first walk goes to when it skips or finishes node i (the next
    sibling, or the nearest ancestor's next sibling, or
    ``ESCAPE_SENTINEL`` at the end).  Children of a node are contiguous,
    so the pointers follow from one vectorized sweep a tree level: each
    round sets the children of the parents whose own pointer is known.
    ``nodes_arr`` (N, 4) uint32, the child count in the top 4 bits of
    word 3 and the first child in the low 28."""
    n = len(nodes_arr)
    w = nodes_arr[:, 3]
    nchild = (w >> np.uint32(28)).astype(np.int64)
    first_child = (w & np.uint32(0x0FFFFFFF)).astype(np.int64)
    escape = np.full(n, ESCAPE_SENTINEL, dtype=np.uint32)
    known = np.zeros(n, dtype=bool)
    known[0] = True
    done = np.zeros(n, dtype=bool)
    internal = nchild > 0
    for _ in range(64):
        ready = np.flatnonzero(internal & known & ~done)
        if len(ready) == 0:
            break
        done[ready] = True
        k = nchild[ready]
        child_ids = np.repeat(first_child[ready], k) + _intra_run(k)
        # the next sibling, but the last child inherits its parent's
        esc = (child_ids + 1).astype(np.uint32)
        esc[np.cumsum(k) - 1] = escape[ready]
        escape[child_ids] = esc
        known[child_ids] = True
    return escape


def legacy_walker_arrays(geometry, include_legacy_bvh=None):
    """{nodes, escape, tri_vertices} of the escape-rope walker: packed
    when ``include_legacy_bvh`` (None: the geometry has a BVH and at
    most ``LEGACY_WALKER_MAX_TRIANGLES`` triangles), else the
    placeholders."""
    bvh = geometry.bvh
    if include_legacy_bvh is None:
        include_legacy_bvh = (bvh is not None and len(geometry.mesh.triangles)
                              <= LEGACY_WALKER_MAX_TRIANGLES)
    if not include_legacy_bvh:
        return {k: v.copy() for k, v in LEGACY_PLACEHOLDERS.items()}
    if bvh is None:
        raise ValueError('geometry has no BVH; call '
                         'chroma_tpu_torch.loader.create_geometry_from_obj')
    nodes = from_uint4(bvh.nodes)
    return dict(nodes=nodes, escape=compute_escape_pointers(nodes),
                tri_vertices=np.asarray(
                    geometry.mesh.vertices[geometry.mesh.triangles],
                    np.float32))


def pack_geometry_arrays(geometry, wavelengths=None, times=None,
                         instancing=None, include_legacy_bvh=None):
    """(numpy arrays by field, static fields) for a flattened Geometry;
    ``include_legacy_bvh`` as ``legacy_walker_arrays``."""
    wavelengths = np.asarray(standard_wavelengths if wavelengths is None
                             else wavelengths, dtype=np.float32)
    wavelength_step = _uniform_step(wavelengths, 'wavelengths')
    times = np.asarray(DEFAULT_TIME_GRID if times is None else times,
                       dtype=np.float32)
    time_step = _uniform_step(times, 'times')
    W = len(wavelengths)
    Tn = len(times)

    # ---- materials ----------------------------------------------------
    materials = geometry.unique_materials
    M = len(materials)
    max_comp = max([len(m.comp_reemission_prob) for m in materials] + [1])
    a = dict(
        refractive_index=np.ones((M, W), np.float32),
        absorption_length=np.full((M, W), 1e30, np.float32),
        scattering_length=np.full((M, W), 1e30, np.float32),
        num_comp=np.zeros(M, np.int32),
        comp_reemission_prob=np.zeros((M, max_comp, W), np.float32),
        comp_reemission_wvl_cdf=np.zeros((M, max_comp, W), np.float32),
        comp_reemission_time_cdf=np.zeros((M, max_comp, Tn), np.float32),
        comp_absorption_length=np.full((M, max_comp, W), 1e30, np.float32))
    for i, mat in enumerate(materials):
        if mat is None:
            raise ValueError('one or more triangles is missing a material.')
        for name in ('refractive_index', 'absorption_length',
                     'scattering_length'):
            a[name][i] = interp_material_property(wavelengths,
                                                  getattr(mat, name))
        nc = len(mat.comp_reemission_prob)
        if not (nc == len(mat.comp_reemission_wvl_cdf)
                == len(mat.comp_reemission_time_cdf)
                == len(mat.comp_absorption_length)):
            raise ValueError('component arrays must be same length')
        a['num_comp'][i] = nc
        for c in range(nc):
            a['comp_reemission_prob'][i, c] = interp_material_property(
                wavelengths, mat.comp_reemission_prob[c])
            a['comp_reemission_wvl_cdf'][i, c] = interp_material_property(
                wavelengths, mat.comp_reemission_wvl_cdf[c])
            a['comp_reemission_time_cdf'][i, c] = interp_material_property(
                times, mat.comp_reemission_time_cdf[c])
            a['comp_absorption_length'][i, c] = interp_material_property(
                wavelengths, mat.comp_absorption_length[c])

    # ---- surfaces -----------------------------------------------------
    surfaces = geometry.unique_surfaces
    S = max(len(surfaces), 1)
    surf_names = ('detect', 'absorb', 'reemit', 'reflect_diffuse',
                  'reflect_specular', 'eta', 'k', 'reemission_cdf')
    for name in surf_names:
        a['surf_' + name] = np.zeros((S, W), np.float32)
    a['surf_model'] = np.zeros(S, np.int32)
    a['surf_transmissive'] = np.zeros(S, np.int32)
    a['surf_thickness'] = np.zeros(S, np.float32)
    max_angles = max([2] + [len(s.dichroic_props.angles) for s in surfaces
                            if s is not None
                            and s.dichroic_props is not None])
    a['dichroic_angles'] = np.zeros((S, max_angles), np.float32)
    a['dichroic_nangles'] = np.zeros(S, np.int32)
    a['dichroic_reflect'] = np.zeros((S, max_angles, W), np.float32)
    a['dichroic_transmit'] = np.zeros((S, max_angles, W), np.float32)
    for i, s in enumerate(surfaces):
        if s is None:
            continue
        for name in surf_names:
            a['surf_' + name][i] = interp_material_property(
                wavelengths, getattr(s, name))
        a['surf_model'][i] = s.model
        a['surf_transmissive'][i] = s.transmissive
        a['surf_thickness'][i] = s.thickness
        if s.dichroic_props is not None:
            dp = s.dichroic_props
            na = len(dp.angles)
            a['dichroic_nangles'][i] = na
            a['dichroic_angles'][i, :na] = dp.angles
            for k in range(na):
                a['dichroic_reflect'][i, k] = interp_material_property(
                    wavelengths, dp.dichroic_reflect[k])
                a['dichroic_transmit'][i, k] = interp_material_property(
                    wavelengths, dp.dichroic_transmit[k])

    # ---- inverse CDF tables ---------------------------------------------
    a['comp_reemission_wvl_icdf'] = np.zeros((M, max_comp, N_ICDF),
                                             np.float32)
    a['comp_reemission_time_icdf'] = np.zeros((M, max_comp, N_ICDF),
                                              np.float32)
    for i in range(M):
        for c in range(int(a['num_comp'][i])):
            a['comp_reemission_wvl_icdf'][i, c] = inverse_cdf(
                wavelengths, a['comp_reemission_wvl_cdf'][i, c])
            a['comp_reemission_time_icdf'][i, c] = inverse_cdf(
                times, a['comp_reemission_time_cdf'][i, c])
    a['surf_reemission_icdf'] = np.stack(
        [inverse_cdf(wavelengths, a['surf_reemission_cdf'][i])
         for i in range(S)])

    # ---- triangle material codes (reference ABI) -----------------------
    material_codes = ((geometry.inner_material_index.astype(np.uint32)
                       << np.uint32(24))
                      | (geometry.outer_material_index.astype(np.uint32)
                         << np.uint32(16))
                      | ((geometry.surface_index.astype(np.uint32)
                          & np.uint32(0xFF)) << np.uint32(8)))
    from chroma_tpu_torch.ops.mbvh import MAX_LEVELS
    mbvh = _load_or_build_mbvh(geometry, material_codes,
                               instancing=instancing)
    if mbvh.depth > MAX_LEVELS:
        raise ValueError('MBVH needs %d levels > walker MAX_LEVELS=%d'
                         % (mbvh.depth, MAX_LEVELS))
    bvh = geometry.bvh
    world = mbvh.world_coords
    legacy = bvh.world_coords if bvh is not None else world
    a.update(
        vertices=np.asarray(geometry.mesh.vertices, np.float32),
        triangles=np.asarray(geometry.mesh.triangles, np.int32),
        material_codes=material_codes,
        colors=geometry.colors.astype(np.uint32),
        solid_id_map=geometry.solid_id.astype(np.int32),
        mbvh_rows=mbvh.rows,
        world_origin=np.asarray(world.world_origin, np.float32),
        world_scale=np.asarray(world.world_scale, np.float32),
        legacy_world_origin=np.asarray(legacy.world_origin, np.float32),
        legacy_world_scale=np.asarray(legacy.world_scale, np.float32),
        **legacy_walker_arrays(geometry, include_legacy_bvh))
    static = dict(
        wavelength0=float(wavelengths[0]), wavelength_step=wavelength_step,
        nwavelengths=W, time0=float(times[0]), time_step=time_step,
        ntimes=Tn, mbvh_depth=int(mbvh.depth),
        mbvh_instanced=bool(getattr(mbvh, 'instanced', False)), nu=N_ICDF,
        has_reemission=bool((a['num_comp'] > 0).any()),
        has_surfaces=bool((geometry.surface_index >= 0).any()),
        has_complex=bool((a['surf_model'] == 1).any()),
        has_wls=bool((a['surf_model'] == 2).any()),
        has_dichroic=bool((a['surf_model'] == 3).any()),
        max_comp=max_comp)
    return a, static


def detector_arrays(detector):
    """(numpy arrays by field, static fields) of a Detector's readout."""
    a = dict(
        solid_id_to_channel_index=np.asarray(
            detector.solid_id_to_channel_index, np.int32),
        time_cdf_x=np.asarray(detector.time_cdf[0], np.float32),
        time_cdf_y=np.asarray(detector.time_cdf[1], np.float32),
        charge_cdf_x=np.asarray(detector.charge_cdf[0], np.float32),
        charge_cdf_y=np.asarray(detector.charge_cdf[1], np.float32),
        time_icdf=inverse_cdf(detector.time_cdf[0], detector.time_cdf[1]),
        charge_icdf=inverse_cdf(detector.charge_cdf[0],
                                detector.charge_cdf[1]),
        # the reference DAQ's quantization: charge_cdf_x[-1] / 2**16
        charge_unit=np.float32(detector.charge_cdf[0][-1] / 2 ** 16))
    return a, dict(nchannels=int(detector.num_channels()))


def pack_geometry(geometry, device=None, wavelengths=None, times=None,
                  instancing=None, include_legacy_bvh=None):
    """GeometryTables on ``device`` (default: the card) for a flattened
    Geometry.  ``instancing`` True/False forces the TLAS/BLAS MBVH on or
    off (None decides); ``include_legacy_bvh`` as
    ``legacy_walker_arrays``."""
    device = resolve(device)
    arrays, static = pack_geometry_arrays(geometry, wavelengths, times,
                                          instancing, include_legacy_bvh)
    return tables_from_numpy(arrays, None, {'geom': static}, device)[0]


def pack_detector(detector, device=None, wavelengths=None, times=None):
    """(GeometryTables, DetectorTables) on ``device`` (default: the card)
    for a flattened Detector."""
    device = resolve(device)
    g_arrays, g_static = pack_geometry_arrays(detector, wavelengths, times)
    d_arrays, d_static = detector_arrays(detector)
    return tables_from_numpy(g_arrays, d_arrays,
                             {'geom': g_static, 'det': d_static}, device)


def interp_property(tables, table, material_index, wavelength):
    """Per-photon lookup of a (M, W) wavelength table at (index, lambda):
    clamp to the uniform grid and interpolate linearly (reference:
    chroma/cuda/geometry.h:62).  ``table`` may be (M, C, W) with a
    composite leading index."""
    n = tables.nwavelengths
    x = (wavelength - tables.wavelength0) / tables.wavelength_step
    x = torch.clamp(x, 0.0, n - 1.0)
    jl = torch.clamp(x.to(torch.int32), 0, n - 2).long()
    f = x - jl
    lo = table[material_index, jl]
    hi = table[material_index, jl + 1]
    return lo + (hi - lo) * f

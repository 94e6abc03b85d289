"""Wavefront photon propagation: the physics of one step, branch-free.

Counterpart of chroma_tpu/ops/propagate.py (reference physics:
chroma/cuda/photon.h).  Every photon of the batch advances one step per
call through a lattice of disjoint outcome masks combined with
``torch.where``: closest hit and material decode, absorption (with
reemission) / Rayleigh scattering / boundary, the four surface models,
Fresnel crossing.

Random numbers come in as a draw block ``u`` (n, NDRAWS) of uniforms in
[0, 1), one row per photon, so callers decide where the draws come from
(a ``torch.Generator`` on the main path, the JAX package's own draws in
the tests).

Flags, codes and triangle ids are int32 tensors holding the JAX
package's uint32 bits; every right shift is masked.  Bulk reemission
and the WLS, dichroic and thin-film (complex) surface models run only
for a geometry that uses them (the static ``has_*`` gates of the tables);
``use_weights`` is the variance-reduced mode of the likelihood path.

``physics_update`` dispatches on what it is given: on a CUDA device, for
tables without a WLS, dichroic or thin-film surface, one launch of the
hand-written csrc/physics_step.cu (``physics_update_cuda``, one thread a
photon) computes the step; everywhere else ``physics_update_plain``, the
lattice above in plain PyTorch, does.  The two agree bit for bit on the
card (tests/test_torch_cuda.py).
"""
import ctypes

import numpy as np
import torch

from chroma_tpu_torch import event, tracing
from chroma_tpu_torch.device import resolve
from chroma_tpu_torch.ops import mbvh
from chroma_tpu_torch.ops.mbvh_walk import LaunchCounter
from chroma_tpu_torch.ops.intersect import dot, cross, norm, normalize

SPEED_OF_LIGHT = 299.792458  # mm/ns
PI = 3.141592653589793
WEIGHT_LOWER_THRESHOLD = 1e-4
# what the step loop's walk reads for an exactly zero direction component.
# The walker's slab test leaves an axis with an infinite 1/dir open, so a
# ray parallel to an axis takes every box in its column: on the SNO-like
# table (603,675 rows) it outruns max_iters on every step, comes back
# incomplete and never moves.  A uniform draw of exactly 0 in
# uniform_sphere gives such a ray (a pole).  This component keeps the
# slab closed to boxes the ray cannot reach and moves no float32 hit.
AXIS_TINY = 1e-30

# draw-block slots (same as the JAX package)
NDRAWS = 20
(U_ABSORB, U_SCATTER, U_COMP, U_REEMIT, U_REEMIT_WVL, U_REEMIT_TIME,
 U_SPHERE1A, U_SPHERE1B, U_SPHERE2A, U_SPHERE2B, U_RAYL_COS, U_RAYL_PHI,
 U_POL_BRANCH, U_REFLECT, U_SURFACE, U_SURFACE2, U_DIFF1, U_DIFF2,
 U_WLS, U_SPARE) = range(NDRAWS)


def i32(x):
    """A uint32 bit pattern as the int32 value with the same bits."""
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


TERMINAL = i32(event.TERMINAL_FLAGS)


def alive_mask(flags):
    return (flags & TERMINAL) == 0


def sext_byte(x):
    """Sign-extend the low byte (reference: chroma/cuda/photon.h:68)."""
    x = x & 0xFF
    return torch.where(x >= 0x80, x - 256, x)


def rotate(a, phi, n):
    """Rodrigues rotation of vectors ``a`` by angle phi about axis n."""
    cos_phi = torch.cos(phi)[..., None]
    sin_phi = torch.sin(phi)[..., None]
    return (a * cos_phi + n * dot(a, n)[..., None] * (1 - cos_phi)
            + cross(a, n) * sin_phi)


def uniform_sphere(u1, u2):
    """Uniform unit vectors from two uniforms."""
    theta = 2.0 * PI * u1
    z = 2.0 * u2 - 1.0
    c = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([c * torch.cos(theta), c * torch.sin(theta), z],
                       dim=-1)


def pick_new_direction(axis, theta, phi):
    """Direction at polar angle (theta, phi) relative to ``axis``
    (reference: chroma/cuda/photon.h:137)."""
    cos_theta, sin_theta = torch.cos(theta), torch.sin(theta)
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    sin_axis_theta = torch.sqrt(torch.clamp(1.0 - az * az, min=0.0))
    degenerate = sin_axis_theta < 1e-5
    safe = torch.where(degenerate, 1.0, sin_axis_theta)
    cos_axis_phi = torch.where(degenerate, 1.0, ax / safe)
    sin_axis_phi = torch.where(degenerate, 0.0, ay / safe)
    dirx = cos_theta * ax + sin_theta * (
        az * cos_phi * cos_axis_phi - sin_phi * sin_axis_phi)
    diry = cos_theta * ay + sin_theta * (
        cos_phi * az * sin_axis_phi + sin_phi * cos_axis_phi)
    dirz = cos_theta * az - sin_theta * cos_phi * sin_axis_theta
    return torch.stack([dirx, diry, dirz], dim=-1)


def cosine_hemisphere(normal, u1, u2, tangent_seed):
    """Cosine-weighted directions about ``normal``."""
    t1 = normalize(cross(normal, tangent_seed))
    t2 = cross(normal, t1)
    phi = 2.0 * PI * u1
    r = torch.sqrt(u2)
    z = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    return (r * torch.cos(phi))[..., None] * t1 \
        + (r * torch.sin(phi))[..., None] * t2 + z[..., None] * normal


def _grid_index(tables, wavelength):
    """(lower grid index, fraction) of each wavelength on the uniform
    grid.  Float-to-int conversion saturates with NaN -> 0, as XLA's."""
    w0, dw, nw = tables.wavelength0, tables.wavelength_step, \
        tables.nwavelengths
    x = torch.clamp((wavelength - w0) / dw, 0.0, nw - 1.0)
    jl = torch.clamp(torch.nan_to_num(x, nan=0.0), 0, nw - 2) \
        .to(torch.int64)
    return jl, x - jl


def _interp(tables, table, idx, wavelength):
    """Wavelength-interpolated lookup of a stacked (K, W) table at row
    ``idx`` (reference: chroma/cuda/geometry.h interp_property)."""
    jl, f = _grid_index(tables, wavelength)
    flat = table.reshape(-1)
    base = idx.to(torch.int64) * tables.nwavelengths + jl
    lo = flat[base]
    hi = flat[base + 1]
    return lo + (hi - lo) * f


def _interp_rows(tables, stacked, idx, wavelength):
    """Wavelength-interpolated fetch of a (K, W, P) property stack at
    per-photon row ``idx``: all P properties from one paired gather."""
    jl, f = _grid_index(tables, wavelength)
    flat = stacked.reshape(-1, stacked.shape[-1])
    base = idx.to(torch.int64) * tables.nwavelengths + jl
    lo = flat[base]
    hi = flat[base + 1]
    return lo + (hi - lo) * f[:, None]


def _sample_icdf_flat(icdf, row_idx, u):
    """Sample a stacked inverse-CDF table (R, NU) at per-photon rows."""
    nu = icdf.shape[-1]
    x = u * (nu - 1)
    j = torch.clamp(torch.nan_to_num(x, nan=0.0), 0, nu - 2).to(torch.int64)
    f = x - j
    flat = icdf.reshape(-1)
    base = row_idx.to(torch.int64) * nu + j
    lo = flat[base]
    hi = flat[base + 1]
    return lo + (hi - lo) * f


def make_photon_state(n=None, pos=None, dir=None, pol=None, wavelength=None,
                      t=None, weight=None, flags=None, last_hit_triangle=None,
                      evidx=None, device=None):
    """SoA photon state dict of tensors on ``device`` (default: the
    card).  ``flags`` and ``evidx`` are int32 with the uint32 bits;
    ``index`` records each photon's original batch position."""
    device = resolve(device)
    n = n if n is not None else len(pos)

    def arr(x, default, shape, dtype):
        if x is None:
            return torch.full(shape, default, dtype=dtype, device=device)
        return torch.as_tensor(x, device=device).to(dtype)

    return dict(
        pos=arr(pos, 0.0, (n, 3), torch.float32),
        dir=arr(dir, 0.0, (n, 3), torch.float32),
        pol=arr(pol, 0.0, (n, 3), torch.float32),
        wavelength=arr(wavelength, 0.0, (n,), torch.float32),
        t=arr(t, 0.0, (n,), torch.float32),
        weight=arr(weight, 1.0, (n,), torch.float32),
        flags=arr(flags, 0, (n,), torch.int32),
        last_hit_triangle=arr(last_hit_triangle, -1, (n,), torch.int32),
        evidx=arr(evidx, 0, (n,), torch.int32),
        index=torch.arange(n, dtype=torch.int64, device=device),
    )


def _fresnel(state, normal, n1, n2, u_branch, u_reflect):
    """Polarization-resolved Fresnel refraction/reflection (reference:
    chroma/cuda/photon.h:310).  Returns (new_dir, new_pol, reflected)."""
    d = state['dir']
    pol = state['pol']
    cos_i = torch.clamp(dot(normal, -d), -1.0, 1.0)
    incident_angle = torch.arccos(cos_i)
    sin_i = torch.sin(incident_angle)
    sin_r = sin_i * n1 / n2
    tir = sin_r > 1.0
    refracted_angle = torch.arcsin(torch.clamp(sin_r, -1.0, 1.0))

    ipn = _in_plane_normal(d, normal, pol)

    normal_coefficient = dot(pol, ipn)
    s_fraction = normal_coefficient * normal_coefficient
    s_branch = u_branch < s_fraction

    sum_angle = incident_angle + refracted_angle
    diff_angle = incident_angle - refracted_angle
    near_normal = sum_angle < 1e-6
    r_s = torch.where(near_normal, (n1 - n2) / (n1 + n2),
                      -torch.sin(diff_angle)
                      / torch.where(near_normal, 1.0, torch.sin(sum_angle)))
    tan_sum = torch.tan(sum_angle)
    r_p = torch.where(near_normal, (n1 - n2) / (n1 + n2),
                      torch.tan(diff_angle)
                      / torch.where(torch.abs(tan_sum) < 1e-20, 1.0,
                                    tan_sum))
    r = torch.where(s_branch, r_s, r_p)
    reflect = tir | (u_reflect < r * r)

    d_reflect = d + 2.0 * cos_i[..., None] * normal
    eta = n1 / n2
    cos_r = torch.cos(refracted_angle)
    d_refract = eta[..., None] * d + (eta * cos_i - cos_r)[..., None] * normal

    new_dir = torch.where(reflect[..., None], d_reflect, d_refract)
    # s-polarized: polarization stays normal to the plane of incidence;
    # p-polarized: in-plane, perpendicular to the new direction
    pol_p = normalize(cross(ipn, new_dir))
    new_pol = torch.where(s_branch[..., None], ipn, pol_p)
    return new_dir, new_pol, reflect


def _rayleigh(state, u_cos, u_phi):
    """Polarization-correct Rayleigh scattering (reference:
    chroma/cuda/photon.h:167).  Returns (dir, pol)."""
    pol = state['pol']
    cos_theta = 2.0 * torch.cos((torch.arccos(1.0 - 2.0 * u_cos) - 2 * PI)
                                / 3.0)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    phi = 2.0 * PI * u_phi
    new_dir = pick_new_direction(pol, theta, phi)
    near_pole = 1.0 - torch.abs(cos_theta) < 1e-6
    pol_pole = pick_new_direction(pol, torch.full_like(theta, PI / 2.0), phi)
    pol_gen = pol - cos_theta[..., None] * new_dir
    new_pol = torch.where(near_pole[..., None], pol_pole, pol_gen)
    return normalize(new_dir), normalize(new_pol)


def propagate_step(state, tables, u, scatter_first=0, use_weights=False):
    """Advance every live photon of ``state`` by one step, with the draw
    block ``u`` (n, NDRAWS).  Returns the new state."""
    with tracing.span('step.walk'):     # the guard's mask is the walk's
        flags = state['flags']
        alive0 = alive_mask(flags)
        # NaN guard (reference: chroma/cuda/propagate.cu:262)
        bad = torch.isnan(state['dir'].sum(dim=1) + state['pos'].sum(dim=1))
        nan_mask = alive0 & bad
        flags = torch.where(nan_mask,
                            flags | i32(event.NO_HIT | event.NAN_ABORT),
                            flags)
        active = alive0 & ~bad
        walk_dir = torch.where(state['dir'] == 0.0, AXIS_TINY, state['dir'])
        res = mbvh.intersect_mesh(state['pos'], walk_dir, tables,
                                  state['last_hit_triangle'], active=active)
    with tracing.span('step.physics'):
        return physics_update(state, res, tables, u, flags, active, nan_mask,
                              scatter_first, use_weights=use_weights)


def _in_plane_normal(d, normal, pol):
    """Unit normal of the plane of incidence; at normal incidence the
    polarization stands in for it."""
    ipn = cross(d, normal)
    ipn_len = norm(ipn)
    small = ipn_len < 1e-6
    return torch.where(small[..., None], pol,
                       ipn / torch.where(small, 1.0, ipn_len)[..., None])


def physics_update(state, res, tables, u, flags, active, nan_mask,
                   scatter_first=0, use_weights=False):
    """The physics half of a step: consume a traversal result ``res``
    (triangle / distance / normal / material_code / incomplete) and
    return the advanced photon state.  ``scatter_first`` (+1 force, -1
    forbid first-interaction scattering) is a scalar or per-photon.
    ``use_weights`` trades bulk and surface absorption for a weight
    below 1 and forces detection on detecting surfaces (reference:
    chroma/cuda/photon.h:200-232, 672-733).

    Where ``kernel_serves`` the tables on the state's device, one launch
    of csrc/physics_step.cu computes it (``physics_update_cuda``, bit for
    bit the plain version's result) and the counter
    ``step.physics_kernel_photons`` adds the call's photons; otherwise
    ``physics_update_plain`` does."""
    if kernel_serves(tables, state['pos'].device):
        new = physics_update_cuda(state, res, tables, u, flags, active,
                                  nan_mask, scatter_first, use_weights)
        tracing.count('step.physics_kernel_photons', state['pos'].shape[0])
        return new
    return physics_update_plain(state, res, tables, u, flags, active,
                                nan_mask, scatter_first, use_weights)


def kernel_serves(tables, device):
    """Whether csrc/physics_step.cu computes ``physics_update`` for these
    tables on ``device``: a CUDA device and no WLS, dichroic or thin-film
    surface (those models run in the plain version only)."""
    return device.type == 'cuda' and not (
        tables.has_wls or tables.has_dichroic or tables.has_complex)


# csrc/physics_step.cu's per-photon pointer slots, in the order of its
# enum Slot: (where, key, dtype, shape past the photon axis)
_PHOTON_SLOTS = (
    ('state', 'pos', torch.float32, (3,)),
    ('state', 'dir', torch.float32, (3,)),
    ('state', 'pol', torch.float32, (3,)),
    ('state', 'wavelength', torch.float32, ()),
    ('state', 't', torch.float32, ()),
    ('state', 'weight', torch.float32, ()),
    ('state', 'flags', torch.int32, ()),
    ('state', 'last_hit_triangle', torch.int32, ()),
    ('res', 'triangle', torch.int32, ()),
    ('res', 'distance', torch.float32, ()),
    ('res', 'normal', torch.float32, (3,)),
    ('res', 'material_code', torch.int32, ()),
    ('res', 'incomplete', torch.bool, ()),
    ('arg', 'u', torch.float32, (NDRAWS,)),
    ('arg', 'flags', torch.int32, ()),
    ('arg', 'active', torch.bool, ()),
    ('arg', 'nan_mask', torch.bool, ()),
)
# then scatter_first, then the tables' slots: (key, dtype, shape in M
# materials, W wavelengths, C components, U inverse-CDF nodes and S
# surfaces, the gate under which the kernel reads it)
_TABLE_SLOTS = (
    ('refractive_index', torch.float32, 'MW', None),
    ('absorption_length', torch.float32, 'MW', None),
    ('scattering_length', torch.float32, 'MW', None),
    ('num_comp', torch.int32, 'M', 'has_reemission'),
    ('comp_absorption_length', torch.float32, 'MCW', 'has_reemission'),
    ('comp_reemission_prob', torch.float32, 'MCW', 'has_reemission'),
    ('comp_reemission_wvl_icdf', torch.float32, 'MCU', 'has_reemission'),
    ('comp_reemission_time_icdf', torch.float32, 'MCU', 'has_reemission'),
    ('surf_detect', torch.float32, 'SW', 'has_surfaces'),
    ('surf_absorb', torch.float32, 'SW', 'has_surfaces'),
    ('surf_reflect_diffuse', torch.float32, 'SW', 'has_surfaces'),
    ('surf_reflect_specular', torch.float32, 'SW', 'has_surfaces'),
    ('surf_model', torch.int32, 'S', 'has_surfaces'),
)
# then the outputs
_OUT_SLOTS = _PHOTON_SLOTS[:8]
physics_launches = LaunchCounter()


def _checked(named, dev):
    """Each (name, tensor, dtype, shape) of ``named`` made contiguous,
    once every dtype and shape, and then every device, is as the kernel
    reads it."""
    for name, t, dtype, shape in named:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype \
                or tuple(t.shape) != tuple(shape):
            raise ValueError('%s must be %s %s, got %s %s'
                             % (name, dtype, tuple(shape),
                                getattr(t, 'dtype', type(t)),
                                tuple(getattr(t, 'shape', ()))))
    for name, t, _, _ in named:
        if t.device != dev or dev.type != 'cuda':
            raise ValueError('%s must be a CUDA tensor on %s, got %s'
                             % (name, dev, t.device))
    return [t.contiguous() for _, t, _, _ in named]


def physics_update_cuda(state, res, tables, u, flags, active, nan_mask,
                        scatter_first=0, use_weights=False):
    """Launch csrc/physics_step.cu: ``physics_update`` on CUDA tensors,
    one thread a photon, for tables without a WLS, dichroic or thin-film
    surface.  ``scatter_first`` is a Python int or an integer tensor,
    per photon or 0-d.  Returns the new state, ``evidx`` and ``index``
    passed through."""
    from chroma_tpu_torch import _build
    if tables.has_wls or tables.has_dichroic or tables.has_complex:
        raise ValueError('the physics kernel has no WLS, dichroic or '
                         'thin-film surface model: use the plain version')
    n = state['pos'].shape[0]
    dev = state['pos'].device
    args = dict(state=state, res=res,
                arg=dict(u=u, flags=flags, active=active, nan_mask=nan_mask))
    dims = dict(M=tables.refractive_index.shape[0],
                W=int(tables.nwavelengths), C=int(tables.max_comp),
                U=int(tables.nu), S=tables.surf_detect.shape[0])
    photon = _checked([('%s %s' % (where, key), args[where][key], dtype,
                        (n,) + tail)
                       for where, key, dtype, tail in _PHOTON_SLOTS], dev)
    read = [slot for slot in _TABLE_SLOTS
            if slot[3] is None or getattr(tables, slot[3])]
    table = dict(zip([slot[0] for slot in read], _checked(
        [('tables.' + key, getattr(tables, key), dtype,
          [dims[c] for c in shape]) for key, dtype, shape, _ in read], dev)))
    ptrs = [t.data_ptr() for t in photon]

    sf_scalar = 0
    if isinstance(scatter_first, (int, np.integer)):
        sf_scalar = int(scatter_first)
        ptrs.append(None)
    else:
        sf = torch.as_tensor(scatter_first, device=dev)
        if sf.dtype.is_floating_point or sf.dtype.is_complex \
                or sf.shape not in ((), (n,)):
            raise ValueError('scatter_first must be an int or an integer '
                             'tensor, 0-d or of one value a photon; got '
                             '%s %s' % (sf.dtype, tuple(sf.shape)))
        sf = sf.to(torch.int32).expand(n).contiguous()
        ptrs.append(sf.data_ptr())

    ptrs += [table[key].data_ptr() if key in table else None
             for key, _, _, _ in _TABLE_SLOTS]

    out = {key: torch.empty((n,) + tail, dtype=dtype, device=dev)
           for _, key, dtype, tail in _OUT_SLOTS}
    ptrs += [out[key].data_ptr() for _, key, _, _ in _OUT_SLOTS]
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.physics_step(
            (ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs), n, dims['M'],
            dims['W'], dims['C'], dims['U'], dims['S'], sf_scalar,
            float(tables.wavelength0), float(tables.wavelength_step),
            int(bool(tables.has_reemission)),
            int(bool(tables.has_surfaces)), int(bool(use_weights)), stream)
    if err != 0:
        raise RuntimeError('physics_step launch failed: cudaError %d' % err)
    physics_launches.add()
    out.update(evidx=state['evidx'], index=state['index'])
    return out


def physics_update_plain(state, res, tables, u, flags, active, nan_mask,
                         scatter_first=0, use_weights=False):
    """``physics_update`` in plain PyTorch, on any device and for every
    surface model: a lattice of disjoint outcome masks combined with
    ``torch.where``.  ``step.reemit`` times its bulk reemission."""
    n = state['pos'].shape[0]
    dev = state['pos'].device
    alive = active & ~res['incomplete']
    tri = res['triangle']
    d_bound = res['distance']
    hit = alive & (tri >= 0)
    flags = torch.where(alive & ~hit, flags | event.NO_HIT, flags)

    code = res['material_code']
    inner_idx = sext_byte(code >> 24)
    outer_idx = sext_byte(code >> 16)
    surface_idx = sext_byte(code >> 8)

    raw_normal = normalize(res['normal'])
    outside_in = dot(raw_normal, -state['dir']) > 0.0
    nmat = tables.refractive_index.shape[0]
    m1 = torch.clamp(torch.where(outside_in, outer_idx, inner_idx), 0,
                     nmat - 1)
    m2 = torch.clamp(torch.where(outside_in, inner_idx, outer_idx), 0,
                     nmat - 1)
    normal = torch.where(outside_in[..., None], raw_normal, -raw_normal)

    wl = state['wavelength']
    bulk = torch.stack([tables.refractive_index, tables.absorption_length,
                        tables.scattering_length], dim=-1)
    bvals = _interp_rows(tables, bulk, m1, wl)
    n1 = bvals[:, 0]
    absorption_length = bvals[:, 1]
    scattering_length = bvals[:, 2]
    n2 = _interp(tables, tables.refractive_index, m2, wl)

    # ---- propagate_to_boundary ----------------------------------------
    eps = 1e-20
    absorption_distance = -absorption_length * torch.log(u[:, U_ABSORB]
                                                         + eps)
    scattering_distance = -scattering_length * torch.log(u[:, U_SCATTER]
                                                         + eps)
    weight = state['weight']
    if use_weights:
        prevent_absorb = weight > WEIGHT_LOWER_THRESHOLD
        absorption_distance = torch.where(prevent_absorb, 1e30,
                                          absorption_distance)

    # forced / forbidden first-interaction scattering via closed-form
    # truncated exponentials (reference photon.h:205-232)
    scatter_first = torch.as_tensor(scatter_first, device=dev)
    scatter_prob = 1.0 - torch.exp(-d_bound / scattering_length)
    force = (scatter_first == 1) & (scatter_prob > WEIGHT_LOWER_THRESHOLD)
    sd_forced = -scattering_length * torch.log1p(
        -u[:, U_SCATTER] * scatter_prob)
    no_scatter_prob = torch.exp(-d_bound / scattering_length)
    forbid = (scatter_first == -1) \
        & (no_scatter_prob > WEIGHT_LOWER_THRESHOLD)
    sd_forbidden = d_bound - scattering_length * torch.log(
        u[:, U_SCATTER] + eps)
    scattering_distance = torch.where(force, sd_forced, scattering_distance)
    scattering_distance = torch.where(forbid, sd_forbidden,
                                      scattering_distance)
    weight = torch.where(hit & force, weight * scatter_prob, weight)
    weight = torch.where(hit & forbid, weight * no_scatter_prob, weight)

    absorb_evt = hit & (absorption_distance <= scattering_distance) \
        & (absorption_distance <= d_bound)
    scatter_evt = hit & ~absorb_evt \
        & (scattering_distance < absorption_distance) \
        & (scattering_distance <= d_bound)
    boundary_evt = hit & ~absorb_evt & ~scatter_evt

    event_dist = torch.where(absorb_evt, absorption_distance,
                             torch.where(scatter_evt, scattering_distance,
                                         d_bound))
    event_dist = torch.where(hit, event_dist, 0.0)
    pos = state['pos'] + event_dist[..., None] * state['dir']
    t = state['t'] + event_dist * n1 / SPEED_OF_LIGHT

    if use_weights:
        # below the threshold a photon is absorbed again, unweighted
        # (reference photon.h:200-203)
        weight = torch.where(
            (scatter_evt | boundary_evt) & prevent_absorb,
            weight * torch.exp(-event_dist / absorption_length), weight)

    dirv = state['dir']
    pol = state['pol']
    new_wl = wl
    lht = torch.where(hit, tri, state['last_hit_triangle'])

    # ---- bulk absorption / reemission ----------------------------------
    dead_absorb = absorb_evt
    if tables.has_reemission:
        with tracing.span('step.reemit'):
            # the absorbing component: cumulative abs/comp_abs against u
            # (reference photon.h:245-252)
            W = tables.nwavelengths
            ncomp = tables.num_comp[m1]
            comp_abs_tab = tables.comp_absorption_length.reshape(-1, W)
            cum = torch.zeros(n, dtype=torch.float32, device=dev)
            comp_sel = torch.zeros(n, dtype=torch.int32, device=dev)
            chosen = torch.zeros(n, dtype=torch.bool, device=dev)
            for ci in range(tables.max_comp):
                comp_abs = _interp(tables, comp_abs_tab,
                                   m1 * tables.max_comp + ci, wl)
                cum = cum + absorption_length / comp_abs
                take = ~chosen & (ci < ncomp) \
                    & ((u[:, U_COMP] < cum) | (ci + 1 >= ncomp))
                comp_sel = torch.where(take, ci, comp_sel)
                chosen = chosen | take
            comp_row = m1 * tables.max_comp + comp_sel
            reemit_prob = _interp(tables,
                                  tables.comp_reemission_prob.reshape(-1, W),
                                  comp_row, wl)
            reemit = absorb_evt & (ncomp > 0) & (u[:, U_REEMIT] < reemit_prob)
            dead_absorb = absorb_evt & ~reemit

            re_wl = _sample_icdf_flat(
                tables.comp_reemission_wvl_icdf.reshape(-1, tables.nu),
                comp_row, u[:, U_REEMIT_WVL])
            re_dt = _sample_icdf_flat(
                tables.comp_reemission_time_icdf.reshape(-1, tables.nu),
                comp_row, u[:, U_REEMIT_TIME])
            re_dir = uniform_sphere(u[:, U_SPHERE1A], u[:, U_SPHERE1B])
            re_pol = normalize(cross(uniform_sphere(u[:, U_SPHERE2A],
                                                    u[:, U_SPHERE2B]), re_dir))
            new_wl = torch.where(reemit, re_wl, new_wl)
            t = torch.where(reemit, t + re_dt, t)
            dirv = torch.where(reemit[..., None], re_dir, dirv)
            pol = torch.where(reemit[..., None], re_pol, pol)
            flags = torch.where(reemit, flags | event.BULK_REEMIT, flags)

    flags = torch.where(dead_absorb, flags | event.BULK_ABSORB, flags)
    lht = torch.where(absorb_evt | scatter_evt, -1, lht)

    # ---- Rayleigh scattering -------------------------------------------
    ray_dir, ray_pol = _rayleigh(state, u[:, U_RAYL_COS], u[:, U_RAYL_PHI])
    dirv = torch.where(scatter_evt[..., None], ray_dir, dirv)
    pol = torch.where(scatter_evt[..., None], ray_pol, pol)
    flags = torch.where(scatter_evt, flags | event.RAYLEIGH_SCATTER, flags)

    # ---- surface interaction -------------------------------------------
    to_fresnel = boundary_evt
    if tables.has_surfaces:
        s_idx = torch.clamp(surface_idx, 0, tables.surf_detect.shape[0] - 1)
        at_surface = boundary_evt & (surface_idx >= 0)
        model = tables.surf_model[s_idx]

        tangent_seed = uniform_sphere(u[:, U_SPHERE2A], u[:, U_SPHERE2B])
        diff_dir = cosine_hemisphere(normal, u[:, U_DIFF1], u[:, U_DIFF2],
                                     tangent_seed)
        diff_pol = normalize(cross(tangent_seed, diff_dir))
        cos_i = torch.clamp(dot(normal, -state['dir']), -1.0, 1.0)
        spec_dir = state['dir'] + 2.0 * cos_i[..., None] * normal

        spack = torch.stack([tables.surf_detect, tables.surf_absorb,
                             tables.surf_reflect_diffuse,
                             tables.surf_reflect_specular], dim=-1)
        svals = _interp_rows(tables, spack, s_idx, wl)
        detect_p, absorb_p = svals[:, 0], svals[:, 1]
        rdiff_p, rspec_p = svals[:, 2], svals[:, 3]
        us = u[:, U_SURFACE]

        # ---------- DEFAULT model (photon.h:684) ------------------------
        is_default = at_surface & (model == 0)
        dp, ap, rd, rs = detect_p, absorb_p, rdiff_p, rspec_p
        if use_weights:
            reweight = (weight > WEIGHT_LOWER_THRESHOLD) \
                & (ap < 1.0 - WEIGHT_LOWER_THRESHOLD)
            survive = 1.0 - ap
            dp = torch.where(reweight, dp / survive, dp)
            rd = torch.where(reweight, rd / survive, rd)
            rs = torch.where(reweight, rs / survive, rs)
            ap = torch.where(reweight, 0.0, ap)
            weight = torch.where(is_default & reweight, weight * survive,
                                 weight)
            # forced detection: the photon ends here with weight * detect
            w_detect = is_default & (dp > 0.0)
            weight = torch.where(w_detect, weight * dp, weight)
            flags = torch.where(w_detect, flags | event.SURFACE_DETECT,
                                flags)
            is_default = is_default & ~w_detect

        df_absorb = is_default & (us < ap)
        df_detect = is_default & ~df_absorb & (us < ap + dp)
        diffuse_out = is_default & (us >= ap + dp) & (us < ap + dp + rd)
        spec_out = is_default & (us >= ap + dp + rd) \
            & (us < ap + dp + rd + rs)
        surf_pass = is_default & (us >= ap + dp + rd + rs)
        flags = torch.where(df_absorb, flags | event.SURFACE_ABSORB, flags)
        flags = torch.where(df_detect, flags | event.SURFACE_DETECT, flags)

        # ---------- WLS model (photon.h:592) ----------------------------
        if tables.has_wls:
            is_wls = at_surface & (model == 2)
            reemit_p = _interp(tables, tables.surf_reemit, s_idx, wl)
            ap_w, rd_w, rs_w = absorb_p, rdiff_p, rspec_p
            if use_weights:
                reweight = (weight > WEIGHT_LOWER_THRESHOLD) \
                    & (ap_w < 1.0 - WEIGHT_LOWER_THRESHOLD)
                survive = 1.0 - ap_w
                rd_w = torch.where(reweight, rd_w / survive, rd_w)
                rs_w = torch.where(reweight, rs_w / survive, rs_w)
                weight = torch.where(is_wls & reweight, weight * survive,
                                     weight)
                ap_w = torch.where(reweight, 0.0, ap_w)
            wls_absorbed = is_wls & (us < ap_w)
            wls_reemit = wls_absorbed & (u[:, U_WLS] < reemit_p)
            wls_dead = wls_absorbed & ~wls_reemit
            wls_reflect = is_wls & ~wls_absorbed \
                & (us < ap_w + rs_w + rd_w)
            wls_pass = is_wls & ~wls_absorbed & ~wls_reflect
            # reflection type, defaulting to diffuse
            ur = u[:, U_SURFACE2] * (rs_w + rd_w)
            wls_spec = wls_reflect & (ur < rs_w)
            wls_diff = wls_reflect & ~wls_spec

            re_wl2 = _sample_icdf_flat(tables.surf_reemission_icdf, s_idx,
                                       u[:, U_REEMIT_WVL])
            re_dir2 = uniform_sphere(u[:, U_SPHERE1A], u[:, U_SPHERE1B])
            re_pol2 = normalize(cross(tangent_seed, re_dir2))
            new_wl = torch.where(wls_reemit, re_wl2, new_wl)
            dirv = torch.where(wls_reemit[..., None], re_dir2, dirv)
            pol = torch.where(wls_reemit[..., None], re_pol2, pol)
            flags = torch.where(wls_reemit, flags | event.SURFACE_REEMIT,
                                flags)
            flags = torch.where(wls_dead, flags | event.SURFACE_ABSORB,
                                flags)
            flags = torch.where(wls_pass, flags | event.SURFACE_TRANSMIT,
                                flags)
            diffuse_out = diffuse_out | wls_diff
            spec_out = spec_out | wls_spec
            surf_pass = surf_pass | wls_pass

        # ---------- dichroic model (photon.h:640) -----------------------
        if tables.has_dichroic:
            is_dich = at_surface & (model == 3)
            refl_prob, tran_prob = _dichroic_probs(tables, s_idx, wl,
                                                   torch.arccos(cos_i))
            dich_spec = is_dich & (us < refl_prob)
            dich_pass = is_dich & ~dich_spec & (us < refl_prob + tran_prob)
            dich_dead = is_dich & ~dich_spec & ~dich_pass
            flags = torch.where(dich_pass, flags | event.SURFACE_TRANSMIT,
                                flags)
            flags = torch.where(dich_dead, flags | event.SURFACE_ABSORB,
                                flags)
            spec_out = spec_out | dich_spec
            surf_pass = surf_pass | dich_pass

        # ---------- complex thin-film model (photon.h:400) --------------
        if tables.has_complex:
            is_cpx = at_surface & (model == 1)
            (cp_detect, cp_absorb, cp_diff, cp_spec, cp_transmit, cp_dir,
             cp_pol, weight) = _propagate_complex(
                 tables, state, s_idx, wl, normal, n1, n2, weight, u,
                 use_weights, is_cpx)
            flags = torch.where(cp_detect, flags | event.SURFACE_DETECT,
                                flags)
            flags = torch.where(cp_absorb, flags | event.SURFACE_ABSORB,
                                flags)
            flags = torch.where(cp_transmit, flags | event.SURFACE_TRANSMIT,
                                flags)
            diffuse_out = diffuse_out | cp_diff
            spec_out = spec_out | cp_spec
            # a transmitted photon refracts within the model
            dirv = torch.where(cp_transmit[..., None], cp_dir, dirv)
            pol = torch.where(cp_transmit[..., None], cp_pol, pol)

        # the reflection outcomes every model shares
        dirv = torch.where(diffuse_out[..., None], diff_dir, dirv)
        pol = torch.where(diffuse_out[..., None], diff_pol, pol)
        flags = torch.where(diffuse_out, flags | event.REFLECT_DIFFUSE,
                            flags)
        dirv = torch.where(spec_out[..., None], spec_dir, dirv)
        flags = torch.where(spec_out, flags | event.REFLECT_SPECULAR, flags)

        to_fresnel = boundary_evt & ((surface_idx < 0) | surf_pass)

    # ---- Fresnel boundary crossing --------------------------------------
    fr_dir, fr_pol, fr_reflected = _fresnel(state, normal, n1, n2,
                                            u[:, U_POL_BRANCH],
                                            u[:, U_REFLECT])
    dirv = torch.where(to_fresnel[..., None], fr_dir, dirv)
    pol = torch.where(to_fresnel[..., None], fr_pol, pol)
    flags = torch.where(to_fresnel & fr_reflected,
                        flags | event.REFLECT_SPECULAR, flags)

    # freeze photons that were not (effectively) alive this step;
    # NaN-aborted photons keep only their new terminal flags
    def keep(old, new):
        mask = alive[..., None] if new.dim() == 2 else alive
        return torch.where(mask, new, old)

    return dict(
        pos=keep(state['pos'], pos),
        dir=keep(state['dir'], dirv),
        pol=keep(state['pol'], pol),
        wavelength=keep(state['wavelength'], new_wl),
        t=keep(state['t'], t),
        weight=keep(state['weight'], weight),
        flags=torch.where(alive | nan_mask, flags, state['flags']),
        last_hit_triangle=keep(state['last_hit_triangle'], lht),
        evidx=state['evidx'],
        index=state['index'],
    )


def _dichroic_probs(tables, s_idx, wl, angle):
    """(reflect, transmit) probabilities of a dichroic surface at
    incidence ``angle``: linear between the rows of the surface's angle
    grid, each row interpolated in wavelength.  The grid row is picked by
    a masked select over the A padded angles, not a search: rows with
    fewer than A angles are zero-padded."""
    A = tables.dichroic_angles.shape[1]
    angles_ph = tables.dichroic_angles[s_idx]          # (n, A)
    na = tables.dichroic_nangles[s_idx]
    col = torch.arange(A, device=angle.device)[None, :]
    below = ((angle[:, None] >= angles_ph) & (col < na[:, None])) \
        .sum(dim=1) - 1
    iidx = torch.minimum(torch.clamp(below, min=0),
                         torch.clamp(na - 2, min=0))
    a_lo = torch.where(col == iidx[:, None], angles_ph, 0.0).sum(dim=1)
    a_hi = torch.where(col == (iidx + 1)[:, None], angles_ph, 0.0).sum(dim=1)
    frac = torch.clamp((angle - a_lo)
                       / torch.where(a_hi > a_lo, a_hi - a_lo, 1.0),
                       0.0, 1.0)
    iidx_hi = torch.where(iidx < na - 2, iidx + 1, iidx)
    W = tables.nwavelengths
    refl2d = tables.dichroic_reflect.reshape(-1, W)
    tran2d = tables.dichroic_transmit.reshape(-1, W)
    r_lo = _interp(tables, refl2d, s_idx * A + iidx, wl)
    r_hi = _interp(tables, refl2d, s_idx * A + iidx_hi, wl)
    t_lo = _interp(tables, tran2d, s_idx * A + iidx, wl)
    t_hi = _interp(tables, tran2d, s_idx * A + iidx_hi, wl)
    return r_lo + (r_hi - r_lo) * frac, t_lo + (t_hi - t_lo) * frac


def thin_film_rta(n1r, n2_eta, n2_k, n3r, cos_t1, wl, thickness):
    """Three-layer thin-film reflect/transmit probabilities.

    The optics of the PMT window model (reference:
    chroma/cuda/photon.h:400): layer 1 (real index ``n1r``) / absorbing
    film (complex ``n2_eta + i n2_k``, ``thickness`` mm) / layer 3 (real
    ``n3r``), photon incident from layer 1 at ``cos_t1`` with wavelength
    ``wl`` nm.  Returns (s_r, s_t, p_r, p_t, n_r, n_t): R and T for s-
    and p-polarization and for normal incidence (the QE normalization).
    Absorption in the film is 1 - R - T.  complex64 throughout."""
    def cplx(x):
        return torch.complex(x, torch.zeros_like(x))

    n1 = cplx(n1r)
    n2 = torch.complex(n2_eta, n2_k)
    n3 = cplx(n3r)

    theta = torch.arccos(torch.clamp(cos_t1, -1.0, 1.0))
    cos1 = cplx(torch.cos(theta))
    sin1 = cplx(torch.sin(theta))

    e = 2.0 * PI * thickness * 1.0e6 / wl  # mm -> nm

    def sq(z):
        return z * z

    # past the critical angle of the exit layer the argument is a
    # negative real with imaginary part +0, so the root is +i|..|: the
    # decaying wave
    cos3 = torch.sqrt(1.0 - sq(n1 / n3) * sq(sin1))
    cos2 = torch.sqrt(1.0 - sq(n1 / n2) * sq(sin1))
    n2cos2 = n2 * cos2
    uu = n2cos2.real
    vv = n2cos2.imag

    def rt(r12, r23, t12, t23, g, u_, v_):
        exp1 = torch.exp(2.0 * v_ * e)
        exp2 = 1.0 / exp1
        ar12, ar23 = torch.abs(r12), torch.abs(r23)
        arg12 = torch.angle(r12)
        arg23 = torch.angle(r23)
        denom = exp1 + ar12 ** 2 * ar23 ** 2 * exp2 \
            + 2.0 * ar12 * ar23 * torch.cos(arg23 + arg12 + 2.0 * u_ * e)
        r = (ar12 ** 2 * exp1 + ar23 ** 2 * exp2
             + 2.0 * ar12 * ar23 * torch.cos(arg23 - arg12 + 2.0 * u_ * e)) \
            / denom
        t = g.real * torch.abs(t12) ** 2 * torch.abs(t23) ** 2 / denom
        return r, t

    # s polarization
    s_n1c1, s_n2c2, s_n3c3 = n1 * cos1, n2 * cos2, n3 * cos3
    s_r, s_t = rt((s_n1c1 - s_n2c2) / (s_n1c1 + s_n2c2),
                  (s_n2c2 - s_n3c3) / (s_n2c2 + s_n3c3),
                  2.0 * s_n1c1 / (s_n1c1 + s_n2c2),
                  2.0 * s_n2c2 / (s_n2c2 + s_n3c3),
                  s_n3c3 / s_n1c1, uu, vv)
    # p polarization
    p_n2c1, p_n3c2 = n2 * cos1, n3 * cos2
    p_n2c3, p_n1c2 = n2 * cos3, n1 * cos2
    p_r, p_t = rt((p_n2c1 - p_n1c2) / (p_n2c1 + p_n1c2),
                  (p_n3c2 - p_n2c3) / (p_n3c2 + p_n2c3),
                  2.0 * n1 * cos1 / (p_n2c1 + p_n1c2),
                  2.0 * n2 * cos2 / (p_n3c2 + p_n2c3),
                  (n3 * cos3) / (n1 * cos1), uu, vv)
    # normal incidence (for QE scaling)
    n_r, n_t = rt((n1 - n2) / (n1 + n2), (n2 - n3) / (n2 + n3),
                  2.0 * n1 / (n1 + n2), 2.0 * n2 / (n2 + n3),
                  n3 / n1, n2_eta, n2_k)
    return s_r, s_t, p_r, p_t, n_r, n_t


def _propagate_complex(tables, state, s_idx, wl, normal, n1r, n3r, weight,
                       u, use_weights, is_cpx):
    """Thin-film PMT optical model with a complex refractive index
    (reference: chroma/cuda/photon.h:400 propagate_complex).  Returns the
    outcome masks (detect, absorb, diffuse, specular, transmit), the
    transmitted direction and polarization, and the new weights."""
    detect = _interp(tables, tables.surf_detect, s_idx, wl)
    reflect_diffuse = _interp(tables, tables.surf_reflect_diffuse, s_idx, wl)
    n2_eta = _interp(tables, tables.surf_eta, s_idx, wl)
    n2_k = _interp(tables, tables.surf_k, s_idx, wl)
    thickness = tables.surf_thickness[s_idx]
    transmissive = tables.surf_transmissive[s_idx] != 0

    d = state['dir']
    cos_t1 = torch.abs(dot(d, normal))
    theta = torch.arccos(torch.clamp(cos_t1, -1.0, 1.0))
    s_r, s_t, p_r, p_t, n_r, n_t = thin_film_rta(
        n1r, n2_eta, n2_k, n3r, cos_t1, wl, thickness)

    # s-polarization fraction, as at a Fresnel boundary
    ipn = _in_plane_normal(d, normal, state['pol'])
    s_fraction = dot(state['pol'], ipn) ** 2

    transmit = s_fraction * s_t + (1.0 - s_fraction) * p_t
    transmit = torch.where(transmissive, transmit, 0.0)
    transmit_n = torch.where(transmissive, n_t, 0.0)
    reflect = s_fraction * s_r + (1.0 - s_fraction) * p_r
    absorb = 1.0 - transmit - reflect
    absorb_n = 1.0 - transmit_n - n_r

    # scale detection efficiency by normal-incidence absorption
    detect = detect / torch.where(torch.abs(absorb_n) > 1e-12, absorb_n, 1.0)

    dead_detect = torch.zeros_like(is_cpx)
    if use_weights:
        reweight = (weight > WEIGHT_LOWER_THRESHOLD) \
            & (absorb < 1.0 - WEIGHT_LOWER_THRESHOLD)
        survive = 1.0 - absorb
        weight = torch.where(is_cpx & reweight, weight * survive, weight)
        detect = torch.where(reweight, detect / survive, detect)
        reflect = torch.where(reweight, reflect / survive, reflect)
        transmit = torch.where(reweight, transmit / survive, transmit)
        absorb = torch.where(reweight, 0.0, absorb)
        dead_detect = is_cpx & (detect > 0.0)
        weight = torch.where(dead_detect, weight * detect, weight)
        is_cpx = is_cpx & ~dead_detect

    us = u[:, U_SURFACE]
    absorbed = is_cpx & (us < absorb)
    cp_detect = absorbed & (u[:, U_SURFACE2] < detect)
    cp_absorb = absorbed & ~cp_detect
    reflected = is_cpx & ~absorbed \
        & ((us < absorb + reflect) | ~transmissive)
    cp_diff = reflected & (u[:, U_REFLECT] < reflect_diffuse)
    cp_spec = reflected & ~cp_diff
    cp_transmit = is_cpx & ~absorbed & ~reflected

    # transmission refracts n1 -> n3
    cos_i = torch.clamp(dot(normal, -d), -1.0, 1.0)
    sin_r = torch.sin(theta) * n1r / n3r
    cos_r = torch.sqrt(torch.clamp(1.0 - sin_r ** 2, min=0.0))
    eta = n1r / n3r
    cp_dir = eta[..., None] * d + (eta * cos_i - cos_r)[..., None] * normal
    cp_pol = normalize(cross(ipn, cp_dir))

    return (dead_detect | cp_detect, cp_absorb, cp_diff, cp_spec,
            cp_transmit, cp_dir, cp_pol, weight)

"""Wavefront photon propagation: the physics of one step, branch-free.

Counterpart of chroma_tpu/ops/propagate.py (reference physics:
chroma/cuda/photon.h).  Every photon of the batch advances one step per
call through a lattice of disjoint outcome masks combined with
``torch.where``: closest hit and material decode, absorption / Rayleigh
scattering / boundary, default-model surfaces, Fresnel crossing.

Random numbers come in as a draw block ``u`` (n, NDRAWS) of uniforms in
[0, 1), one row per photon, so callers decide where the draws come from
(a ``torch.Generator`` on the main path, the JAX package's own draws in
the tests).

Flags, codes and triangle ids are int32 tensors holding the JAX
package's uint32 bits; every right shift is masked.  The static
capability gates of physics this slice does not port (bulk reemission,
WLS, dichroic and thin-film surfaces) raise NotImplementedError.
"""
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.ops import mbvh
from chroma_tpu_torch.ops.intersect import dot, cross, norm, normalize

SPEED_OF_LIGHT = 299.792458  # mm/ns
PI = 3.141592653589793
WEIGHT_LOWER_THRESHOLD = 1e-4

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
                      evidx=None, device='cpu'):
    """SoA photon state dict of tensors on ``device``.  ``flags`` and
    ``evidx`` are int32 with the uint32 bits; ``index`` records each
    photon's original batch position."""
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

    ipn = cross(d, normal)
    ipn_len = norm(ipn)
    # normal incidence: use the polarization as the plane normal
    small = ipn_len < 1e-6
    ipn = torch.where(small[..., None], pol,
                      ipn / torch.where(small, 1.0, ipn_len)[..., None])

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


def _check_gates(tables):
    for gate in ('has_reemission', 'has_wls', 'has_dichroic', 'has_complex'):
        if getattr(tables, gate):
            raise NotImplementedError(
                'physics gate %s is not ported to chroma_tpu_torch yet'
                % gate)


def propagate_step(state, tables, u, scatter_first=0):
    """Advance every live photon of ``state`` by one step, with the draw
    block ``u`` (n, NDRAWS).  Returns the new state."""
    flags = state['flags']
    alive0 = alive_mask(flags)
    # NaN guard (reference: chroma/cuda/propagate.cu:262)
    bad = torch.isnan(state['dir'].sum(dim=1) + state['pos'].sum(dim=1))
    nan_mask = alive0 & bad
    flags = torch.where(nan_mask,
                        flags | i32(event.NO_HIT | event.NAN_ABORT), flags)
    active = alive0 & ~bad
    res = mbvh.intersect_mesh(state['pos'], state['dir'], tables,
                              state['last_hit_triangle'], active=active)
    return physics_update(state, res, tables, u, flags, active, nan_mask,
                          scatter_first)


def physics_update(state, res, tables, u, flags, active, nan_mask,
                   scatter_first=0):
    """The physics half of a step: consume a traversal result ``res``
    (triangle / distance / normal / material_code / incomplete) and
    return the advanced photon state.  ``scatter_first`` (+1 force, -1
    forbid first-interaction scattering) is a scalar or per-photon."""
    _check_gates(tables)
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

    dirv = state['dir']
    pol = state['pol']
    lht = torch.where(hit, tri, state['last_hit_triangle'])

    # ---- bulk absorption (reemission is gated off above) ---------------
    flags = torch.where(absorb_evt, flags | event.BULK_ABSORB, flags)
    lht = torch.where(absorb_evt | scatter_evt, -1, lht)

    # ---- Rayleigh scattering -------------------------------------------
    ray_dir, ray_pol = _rayleigh(state, u[:, U_RAYL_COS], u[:, U_RAYL_PHI])
    dirv = torch.where(scatter_evt[..., None], ray_dir, dirv)
    pol = torch.where(scatter_evt[..., None], ray_pol, pol)
    flags = torch.where(scatter_evt, flags | event.RAYLEIGH_SCATTER, flags)

    # ---- surface interaction (DEFAULT model, photon.h:684) -------------
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
        dp, ap, rd, rs = svals[:, 0], svals[:, 1], svals[:, 2], svals[:, 3]

        is_default = at_surface & (model == 0)
        us = u[:, U_SURFACE]
        df_absorb = is_default & (us < ap)
        df_detect = is_default & ~df_absorb & (us < ap + dp)
        df_diffuse = is_default & (us >= ap + dp) & (us < ap + dp + rd)
        df_spec = is_default & (us >= ap + dp + rd) \
            & (us < ap + dp + rd + rs)
        surf_pass = is_default & (us >= ap + dp + rd + rs)

        flags = torch.where(df_absorb, flags | event.SURFACE_ABSORB, flags)
        flags = torch.where(df_detect, flags | event.SURFACE_DETECT, flags)

        dirv = torch.where(df_diffuse[..., None], diff_dir, dirv)
        pol = torch.where(df_diffuse[..., None], diff_pol, pol)
        flags = torch.where(df_diffuse, flags | event.REFLECT_DIFFUSE, flags)
        dirv = torch.where(df_spec[..., None], spec_dir, dirv)
        flags = torch.where(df_spec, flags | event.REFLECT_SPECULAR, flags)

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
        wavelength=state['wavelength'],
        t=keep(state['t'], t),
        weight=keep(state['weight'], weight),
        flags=torch.where(alive | nan_mask, flags, state['flags']),
        last_hit_triangle=keep(state['last_hit_triangle'], lht),
        evidx=state['evidx'],
        index=state['index'],
    )

// The physics half of a photon step: one thread per photon, one launch a
// call of ops/propagate.physics_update.
//
// Replaces no TPU kernel: the JAX package leaves physics_update
// (chroma_tpu/ops/propagate.py) to XLA, and its plain PyTorch twin,
// ops/propagate.physics_update_plain, issues some two hundred eager ops a
// call.  A photon of the step loop takes 3-4 of its 100 steps, so most
// steps hold a short tail of live photons, and each of those ops costs the
// host a launch, not the device time.  Here a thread reads its photon's
// state, traversal result, draw row and table rows once and writes the new
// state once.
//
// What bounds it on an H100: bytes.  A photon reads 167 B (position,
// direction, polarization, wavelength, time, weight, both flags words and
// the last hit: 60 B; the walk's result: 25 B; its draw row: 80 B; the
// active and NaN masks: 2 B) and writes 56 B, 223 B in all (4 B more
// with a per-photon scatter_first); the tables, a few kB, stay in cache.
// At 3.35 TB/s that is 1.12 ms for 2^24 photons.  No intermediate goes
// through device memory, and a photon computes only the outcome it takes.
//
// Semantics: bit-equal to physics_update_plain on the card.
//   * Built with --fmad=false, so every a*b+c rounds twice, as the
//     separate PyTorch ops do; a dot product is ((x0 + x1) + x2) and every
//     expression keeps the plain code's order.
//   * The same libm calls (logf, log1pf, expf, sinf, cosf, tanf, acosf,
//     asinf, sqrtf), IEEE division and square root.
//   * PyTorch divides a CUDA tensor by a host scalar as a product with the
//     scalar's float32 reciprocal (div_true_kernel_cuda), so where the
//     plain code divides by a Python number, this multiplies by that
//     reciprocal.  Every other constant is the float32 of the Python
//     double the plain code hands PyTorch.
//   * clamp propagates NaN; NaN converts to grid index 0; flags are int32
//     holding uint32 bits, and every shift is masked.
// Builds: <REEMIT, SURFACES, WEIGHTS>, the tables' static gates and
// use_weights, so a detector without reemission carries no reemission
// code.  Tables with a WLS, dichroic or thin-film surface stay on the
// plain path (physics_update dispatches).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 256;

// event.py's flag bits
constexpr int32_t NO_HIT = 1 << 0;
constexpr int32_t BULK_ABSORB = 1 << 1;
constexpr int32_t SURFACE_DETECT = 1 << 2;
constexpr int32_t SURFACE_ABSORB = 1 << 3;
constexpr int32_t RAYLEIGH_SCATTER = 1 << 4;
constexpr int32_t REFLECT_DIFFUSE = 1 << 5;
constexpr int32_t REFLECT_SPECULAR = 1 << 6;
constexpr int32_t BULK_REEMIT = 1 << 9;

// the draw block's slots (ops/propagate.py)
enum Draw {
    U_ABSORB, U_SCATTER, U_COMP, U_REEMIT, U_REEMIT_WVL, U_REEMIT_TIME,
    U_SPHERE1A, U_SPHERE1B, U_SPHERE2A, U_SPHERE2B, U_RAYL_COS, U_RAYL_PHI,
    U_POL_BRANCH, U_REFLECT, U_SURFACE, U_SURFACE2, U_DIFF1, U_DIFF2,
    U_WLS, U_SPARE, NDRAWS
};

// the float32 of the Python doubles ops/propagate.py computes
constexpr double PI_D = 3.141592653589793;
constexpr float TWO_PI = (float)(2.0 * PI_D);
constexpr float HALF_PI = (float)(PI_D / 2.0);
constexpr float EPS = (float)1e-20;
constexpr float FAR = (float)1e30;
constexpr float WLT = (float)1e-4;               // WEIGHT_LOWER_THRESHOLD
constexpr float ONE_LESS_WLT = (float)(1.0 - 1e-4);
constexpr float TINY6 = (float)1e-6;
constexpr float TINY5 = (float)1e-5;
constexpr float TINY20 = (float)1e-20;
constexpr float SPEED_OF_LIGHT = (float)299.792458;   // mm/ns

// the pointer slots, in the order ops/propagate.py lists them:
// _PHOTON_SLOTS, scatter_first, _TABLE_SLOTS, _OUT_SLOTS
enum Slot {
    S_POS, S_DIR, S_POL, S_WL, S_T, S_WEIGHT, S_STATE_FLAGS, S_LHT,
    S_TRI, S_DIST, S_NRM, S_MAT, S_INC, S_U, S_FLAGS, S_ACTIVE, S_NAN,
    S_SF, S_RINDEX, S_ABSLEN, S_SCATLEN, S_NUM_COMP, S_COMP_ABS,
    S_COMP_PROB, S_COMP_WVL_ICDF, S_COMP_TIME_ICDF, S_SURF_DETECT,
    S_SURF_ABSORB, S_SURF_RDIFF, S_SURF_RSPEC, S_SURF_MODEL,
    S_POS_OUT, S_DIR_OUT, S_POL_OUT, S_WL_OUT, S_T_OUT, S_WEIGHT_OUT,
    S_FLAGS_OUT, S_LHT_OUT, NSLOTS
};

struct Args {
    const float *pos, *dir, *pol, *wl, *t, *weight;
    const int32_t *state_flags, *lht;
    const int32_t* tri;
    const float *dist, *nrm;
    const int32_t* mat;
    const uint8_t* inc;
    const float* u;
    const int32_t* flags;
    const uint8_t *active, *nan_mask;
    const int32_t* sf;          // per-photon scatter_first, or null
    const float *rindex, *abslen, *scatlen;
    const int32_t* num_comp;
    const float *comp_abs, *comp_prob, *comp_wvl_icdf, *comp_time_icdf;
    const float *surf_detect, *surf_absorb, *surf_rdiff, *surf_rspec;
    const int32_t* surf_model;
    float *pos_out, *dir_out, *pol_out, *wl_out, *t_out, *weight_out;
    int32_t *flags_out, *lht_out;
    int n, nmat, nw, max_comp, nu, nsurf, sf_scalar;
    float w0, rcp_dw, x_max, j_max, rcp_c, rcp_3;
};

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, long long i) {
    return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
    p[3 * i] = v.x;
    p[3 * i + 1] = v.y;
    p[3 * i + 2] = v.z;
}

__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ float dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 normalize(V3 a) {
    const float len = sqrtf(dot(a, a));
    return {a.x / len, a.y / len, a.z / len};
}

// s * v + w, each product and sum rounded
__device__ __forceinline__ V3 axpy(float s, V3 v, V3 w) {
    return {w.x + s * v.x, w.y + s * v.y, w.z + s * v.z};
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return min(max(x, lo), hi);
}

// sign-extend the low byte (reference: chroma/cuda/photon.h:68)
__device__ __forceinline__ int sext_byte(int32_t x) {
    const int b = x & 0xFF;
    return b >= 0x80 ? b - 256 : b;
}

// _grid_index: the lower grid node and the fraction above it
struct Grid {
    int j;
    float f;
};

__device__ __forceinline__ Grid grid_index(const Args& a, float wl) {
    const float x = clampf((wl - a.w0) * a.rcp_dw, 0.0f, a.x_max);
    const int j = (int)clampf(isnan(x) ? 0.0f : x, 0.0f, a.j_max);
    return {j, x - (float)j};
}

// _interp: row `row` of a (rows, nw) table at the grid position
__device__ __forceinline__ float interp(const float* table, int row, Grid g,
                                        int nw) {
    const int base = row * nw + g.j;
    const float lo = table[base];
    const float hi = table[base + 1];
    return lo + (hi - lo) * g.f;
}

// _sample_icdf_flat: row `row` of a (rows, nu) inverse CDF at uniform u
__device__ __forceinline__ float sample_icdf(const float* icdf, int row,
                                             float u, int nu) {
    const float x = u * (float)(nu - 1);
    const int j = (int)clampf(isnan(x) ? 0.0f : x, 0.0f, (float)(nu - 2));
    const float f = x - (float)j;
    const int base = row * nu + j;
    const float lo = icdf[base];
    const float hi = icdf[base + 1];
    return lo + (hi - lo) * f;
}

__device__ __forceinline__ V3 uniform_sphere(float u1, float u2) {
    const float theta = TWO_PI * u1;
    const float z = 2.0f * u2 - 1.0f;
    const float c = sqrtf(clamp_min(1.0f - z * z, 0.0f));
    return {c * cosf(theta), c * sinf(theta), z};
}

// reference: chroma/cuda/photon.h:137
__device__ __forceinline__ V3 pick_new_direction(V3 axis, float theta,
                                                 float phi) {
    const float cos_theta = cosf(theta), sin_theta = sinf(theta);
    const float cos_phi = cosf(phi), sin_phi = sinf(phi);
    const float sin_axis_theta = sqrtf(clamp_min(1.0f - axis.z * axis.z,
                                                 0.0f));
    const bool degenerate = sin_axis_theta < TINY5;
    const float safe = degenerate ? 1.0f : sin_axis_theta;
    const float cos_axis_phi = degenerate ? 1.0f : axis.x / safe;
    const float sin_axis_phi = degenerate ? 0.0f : axis.y / safe;
    return {cos_theta * axis.x
                + sin_theta * (axis.z * cos_phi * cos_axis_phi
                               - sin_phi * sin_axis_phi),
            cos_theta * axis.y
                + sin_theta * (cos_phi * axis.z * sin_axis_phi
                               + sin_phi * cos_axis_phi),
            cos_theta * axis.z - sin_theta * cos_phi * sin_axis_theta};
}

__device__ __forceinline__ V3 cosine_hemisphere(V3 normal, float u1,
                                                float u2, V3 tangent_seed) {
    const V3 t1 = normalize(cross(normal, tangent_seed));
    const V3 t2 = cross(normal, t1);
    const float phi = TWO_PI * u1;
    const float r = sqrtf(u2);
    const float z = sqrtf(clamp_min(1.0f - u2, 0.0f));
    const float rc = r * cosf(phi), rs = r * sinf(phi);
    return {rc * t1.x + rs * t2.x + z * normal.x,
            rc * t1.y + rs * t2.y + z * normal.y,
            rc * t1.z + rs * t2.z + z * normal.z};
}

// the plane of incidence's unit normal; at normal incidence the
// polarization stands in for it
__device__ __forceinline__ V3 in_plane_normal(V3 d, V3 normal, V3 pol) {
    const V3 ipn = cross(d, normal);
    const float len = sqrtf(dot(ipn, ipn));
    if (len < TINY6) return pol;
    return {ipn.x / len, ipn.y / len, ipn.z / len};
}

// reference: chroma/cuda/photon.h:310; returns whether it reflected
__device__ __forceinline__ bool fresnel(V3 d, V3 pol, V3 normal, float n1,
                                        float n2, float u_branch,
                                        float u_reflect, V3& dir_out,
                                        V3& pol_out) {
    const float cos_i = clampf(dot(normal, neg(d)), -1.0f, 1.0f);
    const float incident_angle = acosf(cos_i);
    const float sin_i = sinf(incident_angle);
    const float sin_r = sin_i * n1 / n2;
    const bool tir = sin_r > 1.0f;
    const float refracted_angle = asinf(clampf(sin_r, -1.0f, 1.0f));
    const V3 ipn = in_plane_normal(d, normal, pol);
    const float normal_coefficient = dot(pol, ipn);
    const bool s_branch =
        u_branch < normal_coefficient * normal_coefficient;
    const float sum_angle = incident_angle + refracted_angle;
    const float diff_angle = incident_angle - refracted_angle;
    float r;
    if (sum_angle < TINY6) {
        r = (n1 - n2) / (n1 + n2);
    } else if (s_branch) {
        r = -sinf(diff_angle) / sinf(sum_angle);
    } else {
        const float tan_sum = tanf(sum_angle);
        r = tanf(diff_angle) / (fabsf(tan_sum) < TINY20 ? 1.0f : tan_sum);
    }
    const bool reflect = tir || u_reflect < r * r;
    if (reflect) {
        dir_out = axpy(2.0f * cos_i, normal, d);
    } else {
        const float eta = n1 / n2;
        const float c = eta * cos_i - cosf(refracted_angle);
        dir_out = {eta * d.x + c * normal.x, eta * d.y + c * normal.y,
                   eta * d.z + c * normal.z};
    }
    pol_out = s_branch ? ipn : normalize(cross(ipn, dir_out));
    return reflect;
}

template <bool REEMIT, bool SURFACES, bool WEIGHTS>
__global__ void __launch_bounds__(BLOCK)
physics_step_kernel(const Args a) {
    const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (i >= a.n) return;

    const V3 pos = load3(a.pos, i), d = load3(a.dir, i),
             pol = load3(a.pol, i);
    const float wl = a.wl[i], t = a.t[i];
    float w = a.weight[i];
    const int32_t lht = a.lht[i];

    // photons not (effectively) alive this step keep their state; a
    // NaN-aborted one takes its new terminal flags
    if (!a.active[i] || a.inc[i]) {
        store3(a.pos_out, i, pos);
        store3(a.dir_out, i, d);
        store3(a.pol_out, i, pol);
        a.wl_out[i] = wl;
        a.t_out[i] = t;
        a.weight_out[i] = w;
        a.flags_out[i] = a.nan_mask[i] ? a.flags[i] : a.state_flags[i];
        a.lht_out[i] = lht;
        return;
    }

    int32_t flags = a.flags[i];
    const int32_t tri = a.tri[i];
    const float d_bound = a.dist[i];
    const bool hit = tri >= 0;
    if (!hit) flags |= NO_HIT;

    const int32_t code = a.mat[i];
    const int inner_idx = sext_byte(code >> 24);
    const int outer_idx = sext_byte(code >> 16);
    const int surface_idx = sext_byte(code >> 8);

    const V3 raw_normal = normalize(load3(a.nrm, i));
    const bool outside_in = dot(raw_normal, neg(d)) > 0.0f;
    const int m1 = clampi(outside_in ? outer_idx : inner_idx, 0, a.nmat - 1);
    const int m2 = clampi(outside_in ? inner_idx : outer_idx, 0, a.nmat - 1);
    const V3 normal = outside_in ? raw_normal : neg(raw_normal);

    const Grid g = grid_index(a, wl);
    const float n1 = interp(a.rindex, m1, g, a.nw);
    const float absorption_length = interp(a.abslen, m1, g, a.nw);
    const float scattering_length = interp(a.scatlen, m1, g, a.nw);
    const float n2 = interp(a.rindex, m2, g, a.nw);
    const float* u = a.u + i * NDRAWS;

    // ---- propagate_to_boundary ----------------------------------------
    bool absorb_evt = false, scatter_evt = false, boundary_evt = false;
    bool prevent_absorb = false;
    float event_dist = 0.0f;
    if (hit) {
        const float u_scatter = u[U_SCATTER];
        float absorption_distance =
            -absorption_length * logf(u[U_ABSORB] + EPS);
        float scattering_distance = -scattering_length * logf(u_scatter + EPS);
        if (WEIGHTS) {
            prevent_absorb = w > WLT;
            if (prevent_absorb) absorption_distance = FAR;
        }
        // forced / forbidden first-interaction scattering (reference
        // photon.h:205-232)
        const int scatter_first = a.sf ? a.sf[i] : a.sf_scalar;
        if (scatter_first == 1) {
            const float scatter_prob =
                1.0f - expf(-d_bound / scattering_length);
            if (scatter_prob > WLT) {
                scattering_distance =
                    -scattering_length * log1pf(-u_scatter * scatter_prob);
                w = w * scatter_prob;
            }
        } else if (scatter_first == -1) {
            const float no_scatter_prob = expf(-d_bound / scattering_length);
            if (no_scatter_prob > WLT) {
                scattering_distance =
                    d_bound - scattering_length * logf(u_scatter + EPS);
                w = w * no_scatter_prob;
            }
        }
        absorb_evt = absorption_distance <= scattering_distance
                     && absorption_distance <= d_bound;
        scatter_evt = !absorb_evt && scattering_distance < absorption_distance
                      && scattering_distance <= d_bound;
        boundary_evt = !absorb_evt && !scatter_evt;
        event_dist = absorb_evt ? absorption_distance
                     : scatter_evt ? scattering_distance : d_bound;
    }
    const V3 new_pos = axpy(event_dist, d, pos);
    float new_t = t + event_dist * n1 * a.rcp_c;
    if (WEIGHTS && (scatter_evt || boundary_evt) && prevent_absorb)
        w = w * expf(-event_dist / absorption_length);

    V3 new_dir = d, new_pol = pol;
    float new_wl = wl;
    int32_t new_lht = hit ? tri : lht;

    // ---- bulk absorption / reemission ----------------------------------
    bool dead_absorb = absorb_evt;
    if (REEMIT && absorb_evt) {
        // the absorbing component: cumulative abs / comp_abs against u
        // (reference photon.h:245-252)
        const int ncomp = a.num_comp[m1];
        float cum = 0.0f;
        int comp_sel = 0;
        for (int ci = 0; ci < a.max_comp; ++ci) {
            const float comp_abs =
                interp(a.comp_abs, m1 * a.max_comp + ci, g, a.nw);
            cum = cum + absorption_length / comp_abs;
            if (ci < ncomp && (u[U_COMP] < cum || ci + 1 >= ncomp)) {
                comp_sel = ci;
                break;
            }
        }
        const int comp_row = m1 * a.max_comp + comp_sel;
        const float reemit_prob = interp(a.comp_prob, comp_row, g, a.nw);
        if (ncomp > 0 && u[U_REEMIT] < reemit_prob) {
            dead_absorb = false;
            new_wl = sample_icdf(a.comp_wvl_icdf, comp_row, u[U_REEMIT_WVL],
                                 a.nu);
            new_t = new_t + sample_icdf(a.comp_time_icdf, comp_row,
                                        u[U_REEMIT_TIME], a.nu);
            new_dir = uniform_sphere(u[U_SPHERE1A], u[U_SPHERE1B]);
            new_pol = normalize(cross(
                uniform_sphere(u[U_SPHERE2A], u[U_SPHERE2B]), new_dir));
            flags |= BULK_REEMIT;
        }
    }
    if (dead_absorb) flags |= BULK_ABSORB;
    if (absorb_evt || scatter_evt) new_lht = -1;

    // ---- Rayleigh scattering (reference photon.h:167) ------------------
    if (scatter_evt) {
        const float cos_theta = clampf(
            2.0f * cosf((acosf(1.0f - 2.0f * u[U_RAYL_COS]) - TWO_PI)
                        * a.rcp_3),
            -1.0f, 1.0f);
        const float phi = TWO_PI * u[U_RAYL_PHI];
        const V3 dir_s = pick_new_direction(pol, acosf(cos_theta), phi);
        const V3 pol_s = 1.0f - fabsf(cos_theta) < TINY6
                             ? pick_new_direction(pol, HALF_PI, phi)
                             : axpy(-cos_theta, dir_s, pol);
        new_dir = normalize(dir_s);
        new_pol = normalize(pol_s);
        flags |= RAYLEIGH_SCATTER;
    }

    // ---- surface interaction: the DEFAULT model (photon.h:684) ---------
    bool to_fresnel = boundary_evt;
    if (SURFACES && boundary_evt && surface_idx >= 0) {
        const int s_idx = clampi(surface_idx, 0, a.nsurf - 1);
        bool surf_pass = false;
        if (a.surf_model[s_idx] == 0) {
            float dp = interp(a.surf_detect, s_idx, g, a.nw);
            float ap = interp(a.surf_absorb, s_idx, g, a.nw);
            float rd = interp(a.surf_rdiff, s_idx, g, a.nw);
            float rs = interp(a.surf_rspec, s_idx, g, a.nw);
            bool is_default = true;
            if (WEIGHTS) {
                if (w > WLT && ap < ONE_LESS_WLT) {
                    const float survive = 1.0f - ap;
                    dp = dp / survive;
                    rd = rd / survive;
                    rs = rs / survive;
                    ap = 0.0f;
                    w = w * survive;
                }
                // forced detection: the photon ends here with
                // weight * detect
                if (dp > 0.0f) {
                    w = w * dp;
                    flags |= SURFACE_DETECT;
                    is_default = false;
                }
            }
            if (is_default) {
                const float us = u[U_SURFACE];
                const float c1 = ap + dp, c2 = c1 + rd, c3 = c2 + rs;
                if (us < ap) flags |= SURFACE_ABSORB;
                else if (us < c1) flags |= SURFACE_DETECT;
                if (us >= c1 && us < c2) {
                    const V3 tangent_seed =
                        uniform_sphere(u[U_SPHERE2A], u[U_SPHERE2B]);
                    new_dir = cosine_hemisphere(normal, u[U_DIFF1],
                                                u[U_DIFF2], tangent_seed);
                    new_pol = normalize(cross(tangent_seed, new_dir));
                    flags |= REFLECT_DIFFUSE;
                }
                if (us >= c2 && us < c3) {
                    const float cos_i =
                        clampf(dot(normal, neg(d)), -1.0f, 1.0f);
                    new_dir = axpy(2.0f * cos_i, normal, d);
                    flags |= REFLECT_SPECULAR;
                }
                surf_pass = us >= c3;
            }
        }
        to_fresnel = surf_pass;
    }

    // ---- Fresnel boundary crossing -------------------------------------
    if (to_fresnel) {
        if (fresnel(d, pol, normal, n1, n2, u[U_POL_BRANCH], u[U_REFLECT],
                    new_dir, new_pol))
            flags |= REFLECT_SPECULAR;
    }

    store3(a.pos_out, i, new_pos);
    store3(a.dir_out, i, new_dir);
    store3(a.pol_out, i, new_pol);
    a.wl_out[i] = new_wl;
    a.t_out[i] = new_t;
    a.weight_out[i] = w;
    a.flags_out[i] = flags;
    a.lht_out[i] = new_lht;
}

template <bool REEMIT, bool SURFACES, bool WEIGHTS>
void launch(const Args& a, cudaStream_t stream) {
    const int grid = (int)(((long long)a.n + BLOCK - 1) / BLOCK);
    physics_step_kernel<REEMIT, SURFACES, WEIGHTS>
        <<<grid, BLOCK, 0, stream>>>(a);
}

template <bool REEMIT, bool SURFACES>
void launch_w(const Args& a, bool weights, cudaStream_t stream) {
    if (weights)
        launch<REEMIT, SURFACES, true>(a, stream);
    else
        launch<REEMIT, SURFACES, false>(a, stream);
}

}  // namespace

// C entry point: `ptrs` holds NSLOTS device pointers in the order of enum
// Slot (S_SF null for a scalar scatter_first, `sf_scalar`; the surface
// slots may be null without surfaces, the reemission slots without
// reemission); `stream` is the CUDA stream to launch on.  Returns the
// cudaError_t of the launch.
extern "C" int physics_step(const void* const* ptrs, int nptrs, int n,
                            int nmat, int nw, int max_comp, int nu,
                            int nsurf, int sf_scalar, float w0, float dw,
                            int has_reemission, int has_surfaces,
                            int use_weights, void* stream) {
    if (nptrs != NSLOTS || nmat < 1 || nw < 2 || max_comp < 1 || nu < 2
        || (has_surfaces && nsurf < 1))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaSuccess;
    auto f = [&](int s) { return static_cast<const float*>(ptrs[s]); };
    auto k = [&](int s) { return static_cast<const int32_t*>(ptrs[s]); };
    auto b = [&](int s) { return static_cast<const uint8_t*>(ptrs[s]); };
    Args a;
    a.pos = f(S_POS);
    a.dir = f(S_DIR);
    a.pol = f(S_POL);
    a.wl = f(S_WL);
    a.t = f(S_T);
    a.weight = f(S_WEIGHT);
    a.state_flags = k(S_STATE_FLAGS);
    a.lht = k(S_LHT);
    a.tri = k(S_TRI);
    a.dist = f(S_DIST);
    a.nrm = f(S_NRM);
    a.mat = k(S_MAT);
    a.inc = b(S_INC);
    a.u = f(S_U);
    a.flags = k(S_FLAGS);
    a.active = b(S_ACTIVE);
    a.nan_mask = b(S_NAN);
    a.sf = k(S_SF);
    a.rindex = f(S_RINDEX);
    a.abslen = f(S_ABSLEN);
    a.scatlen = f(S_SCATLEN);
    a.num_comp = k(S_NUM_COMP);
    a.comp_abs = f(S_COMP_ABS);
    a.comp_prob = f(S_COMP_PROB);
    a.comp_wvl_icdf = f(S_COMP_WVL_ICDF);
    a.comp_time_icdf = f(S_COMP_TIME_ICDF);
    a.surf_detect = f(S_SURF_DETECT);
    a.surf_absorb = f(S_SURF_ABSORB);
    a.surf_rdiff = f(S_SURF_RDIFF);
    a.surf_rspec = f(S_SURF_RSPEC);
    a.surf_model = k(S_SURF_MODEL);
    a.pos_out = const_cast<float*>(f(S_POS_OUT));
    a.dir_out = const_cast<float*>(f(S_DIR_OUT));
    a.pol_out = const_cast<float*>(f(S_POL_OUT));
    a.wl_out = const_cast<float*>(f(S_WL_OUT));
    a.t_out = const_cast<float*>(f(S_T_OUT));
    a.weight_out = const_cast<float*>(f(S_WEIGHT_OUT));
    a.flags_out = const_cast<int32_t*>(k(S_FLAGS_OUT));
    a.lht_out = const_cast<int32_t*>(k(S_LHT_OUT));
    a.n = n;
    a.nmat = nmat;
    a.nw = nw;
    a.max_comp = max_comp;
    a.nu = nu;
    a.nsurf = nsurf;
    a.sf_scalar = sf_scalar;
    a.w0 = w0;
    // the reciprocals PyTorch multiplies by where the plain code divides
    // a tensor by a Python number
    a.rcp_dw = 1.0f / dw;
    a.rcp_c = 1.0f / SPEED_OF_LIGHT;
    a.rcp_3 = 1.0f / 3.0f;
    a.x_max = (float)(nw - 1.0);
    a.j_max = (float)(nw - 2);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool w = use_weights != 0;
    if (has_reemission && has_surfaces)
        launch_w<true, true>(a, w, s);
    else if (has_reemission)
        launch_w<true, false>(a, w, s);
    else if (has_surfaces)
        launch_w<false, true>(a, w, s);
    else
        launch_w<false, false>(a, w, s);
    return (int)cudaGetLastError();
}

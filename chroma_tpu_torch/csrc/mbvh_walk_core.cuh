// One MBVH walk iteration as __device__ functions, shared by the walker
// kernels of this directory:
//
//   mbvh_walk.cu         closest_hit_kernel<INSTANCED>: one thread runs
//                        a ray's whole walk in one launch (K1, K2);
//   mbvh_walk_window.cu  walk_window_kernel<INSTANCED, OD_SLOTS>: one
//                        thread runs n_iters iterations of a lane whose
//                        state lives in device memory across launches,
//                        with the on-deck drain-restart (K3, K4).
//
// Both replace the TPU kernel body `_make_kernel` of
// chroma_tpu/ops/mbvh_pallas.py, whose semantics they keep step for
// step: nearest-first pops on 16-bit quantized entry distances, a level
// is live while its nearest pending code can still beat
// floor(min_dist*sq)+1, the deepest live level is popped, ties go to
// the lowest slot, the improvement test is strict.  Codes are kept
// unbiased here (0..65534 pending, 65535 = absent or popped); the TPU
// kernel biases them by 32768 to fit int16, which preserves every
// comparison.
//
// Floating point: built with --fmad=false and without fast math so every
// a*b+c rounds twice, as the plain PyTorch version in
// chroma_tpu_torch/ops/mbvh_walk.py computes it; results are bit-equal.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace mbvh {

// Row layout of chroma_tpu/bvh/mbvh.py at BRANCH = 64 (the Python
// wrappers check that the packed tables use exactly this layout).
constexpr int BRANCH = 64;
constexpr int ROW_WIDTH = 424;
constexpr int HDR_KIND = 0;
constexpr int HDR_BASE = 1;
constexpr int BOX_OFF = 2;
constexpr int QORIGIN_OFF = 2;
constexpr int QSCALE_OFF = 5;
constexpr int QVERT_OFF = 8;
constexpr int QVERT_WORDS = BRANCH / 2;
constexpr int TRI_ID_OFF = QVERT_OFF + 9 * QVERT_WORDS;
constexpr int MAT_OFF = TRI_ID_OFF + BRANCH;
constexpr int IBOX_ORIGIN_OFF = BOX_OFF + 3 * BRANCH;
constexpr int IBOX_SCALE_OFF = IBOX_ORIGIN_OFF + 3;
constexpr int XFORM_OFF = IBOX_SCALE_OFF + 3;
constexpr int TRI_BASE_OFF = XFORM_OFF + 12;
constexpr uint32_t KIND_CLUSTER = 1;
constexpr uint32_t KIND_LOCAL = 2;
constexpr uint32_t KIND_ENTRY = 4;
constexpr int MAX_SLOTS = 11;          // MAX_LEVELS - 1
constexpr uint32_t SENT = 65535;
constexpr float EPS = 1e-6f;
constexpr float ONE_EPS = (float)(1.0 + 1e-6);
constexpr float FLT_EPS = 1.1920929e-07f;

static_assert(MAT_OFF + BRANCH == ROW_WIDTH, "row layout");
static_assert(TRI_BASE_OFF + 1 <= ROW_WIDTH, "row layout");

// jnp.minimum / jnp.maximum propagate NaN; fminf / fmaxf do not.
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

__device__ __forceinline__ float clip_code(float x) {
    return fminf(fmaxf(x, 0.0f), 65534.0f);
}

// A walker's ray: origin, direction, 1/dir and -org/dir.
struct Ray {
    float o[3], d[3], inv[3], noid[3];
};

__device__ __forceinline__ void set_ray(Ray& r, const float* o,
                                        const float* d) {
    for (int k = 0; k < 3; ++k) {
        r.o[k] = o[k];
        r.d[k] = d[k];
        r.inv[k] = 1.0f / d[k];
        r.noid[k] = -r.o[k] * r.inv[k];
    }
}

// The best hit so far.
struct Hit {
    float min_dist;
    float nrm[3];
    int32_t tri;
    uint32_t mat;
};

__device__ __forceinline__ void clear_hit(Hit& h) {
    h.min_dist = CUDART_INF_F;
    h.nrm[0] = h.nrm[1] = h.nrm[2] = 0.0f;
    h.tri = -1;
    h.mat = 0;
}

// Instance frame of an instanced walk, set by the last entry row (only
// read on KIND_LOCAL rows, which are reachable only after an entry row).
struct Inst {
    float irot[9], iorg[3], idir[3], iinv[3], inoid[3];
    int32_t tbase;
};

// Pending sets: slot s holds tree level s + 1 (level 0, the root, is
// never pending).
struct Pending {
    uint16_t tc[MAX_SLOTS][BRANCH];
    uint32_t bases[MAX_SLOTS];
};

// One axis of a slab test: fold [lo, hi] into (tmin, tmax).  Axes with
// infinite 1/dir are skipped.
__device__ __forceinline__ void slab_axis(int k, float lo, float hi,
                                          float inv, float noid,
                                          float* tmin, float* tmax) {
    const float t0 = lo * inv + noid;
    const float t1 = hi * inv + noid;
    const bool fin = isfinite(inv);
    const float small = fin ? min_nan(t0, t1) : -CUDART_INF_F;
    const float big = fin ? max_nan(t0, t1) : CUDART_INF_F;
    *tmin = k == 0 ? small : max_nan(*tmin, small);
    *tmax = k == 0 ? big : min_nan(*tmax, big);
}

// Slab test of child box j of an internal row (quantized boxes).
__device__ __forceinline__ void slab(const uint32_t* row, int j,
                                     const float* inv, const float* noid,
                                     float* tmin_out, float* tmax_out) {
    float tmin = 0.0f, tmax = 0.0f;
    for (int k = 0; k < 3; ++k) {
        const uint32_t pk = row[BOX_OFF + k * BRANCH + j];
        const float bo = __uint_as_float(row[IBOX_ORIGIN_OFF + k]);
        const float bs = __uint_as_float(row[IBOX_SCALE_OFF + k]);
        const float lo = bo + (float)(pk & 0xFFFFu) * bs;
        const float hi = bo + (float)(pk >> 16) * bs;
        slab_axis(k, lo, hi, inv[k], noid[k], &tmin, &tmax);
    }
    *tmin_out = max_nan(tmin, 0.0f);
    *tmax_out = tmax;
}

// Slab test of root child j from the dequantized boxes `lohi`
// ([lo_x | hi_x | lo_y | hi_y | lo_z | hi_z], BRANCH each; the same
// values `slab` computes from the root row).
__device__ __forceinline__ void slab_lohi(const float* lohi, int j,
                                          const float* inv,
                                          const float* noid,
                                          float* tmin_out, float* tmax_out) {
    float tmin = 0.0f, tmax = 0.0f;
    for (int k = 0; k < 3; ++k)
        slab_axis(k, lohi[(2 * k) * BRANCH + j],
                  lohi[(2 * k + 1) * BRANCH + j], inv[k], noid[k], &tmin,
                  &tmax);
    *tmin_out = max_nan(tmin, 0.0f);
    *tmax_out = tmax;
}

// Root seed: the root's children slab-tested into slot 0 and the
// nearest one popped (ties to the lowest slot).  Children come from
// the root row (`root` non-null) or from its dequantized boxes `lohi`.
// Returns whether a child was popped; sets *ptr (0 when none).
__device__ __forceinline__ bool seed_root(const uint32_t* root,
                                          const float* lohi, int count,
                                          uint32_t base, const Ray& ray,
                                          float sq, bool active,
                                          uint16_t* tc0, uint32_t* ptr) {
    uint32_t best = SENT + 1;
    int c = BRANCH;
    for (int j = 0; j < BRANCH; ++j) {
        float tmin, tmax;
        if (root)
            slab(root, j, ray.inv, ray.noid, &tmin, &tmax);
        else
            slab_lohi(lohi, j, ray.inv, ray.noid, &tmin, &tmax);
        const bool ok = (tmin <= tmax) && (j < count) && active;
        const uint32_t code =
            ok ? (uint32_t)clip_code(floorf(tmin * sq)) : SENT;
        tc0[j] = (uint16_t)code;
        if (ok && code < best) {
            best = code;
            c = j;
        }
    }
    const bool act = c < BRANCH;
    if (act) tc0[c] = (uint16_t)SENT;
    *ptr = act ? base + (uint32_t)c : 0u;
    return act;
}

// Process the row a walk popped last: instance entry, Moller-Trumbore
// on a cluster row's triangles, or a slab test and push of an internal
// row's children at level lvl + 1.
template <bool INSTANCED>
__device__ __forceinline__ void process_row(const uint32_t* row,
                                            const Ray& ray, int32_t lht,
                                            float sq, int depth, int lvl,
                                            Hit& hit, Inst& inst,
                                            Pending& pend) {
    const uint32_t hdr = row[HDR_KIND];
    const int count = (int)(hdr >> 8);
    const bool is_cluster = (hdr & KIND_CLUSTER) != 0;

    const float* eo = ray.o;
    const float* ed = ray.d;
    const float* ei = ray.inv;
    const float* en = ray.noid;
    bool local = false;
    if (INSTANCED) {
        if (hdr & KIND_ENTRY) {
            float xf[12];
            for (int k = 0; k < 12; ++k)
                xf[k] = __uint_as_float(row[XFORM_OFF + k]);
            float omt[3];
            for (int r = 0; r < 3; ++r) omt[r] = ray.o[r] - xf[9 + r];
            for (int k = 0; k < 3; ++k) {
                inst.iorg[k] = xf[k] * omt[0] + xf[3 + k] * omt[1]
                    + xf[6 + k] * omt[2];
                inst.idir[k] = xf[k] * ray.d[0] + xf[3 + k] * ray.d[1]
                    + xf[6 + k] * ray.d[2];
            }
            for (int k = 0; k < 3; ++k) {
                inst.iinv[k] = 1.0f / inst.idir[k];
                inst.inoid[k] = -inst.iorg[k] * inst.iinv[k];
            }
            for (int k = 0; k < 9; ++k) inst.irot[k] = xf[k];
            inst.tbase = (int32_t)row[TRI_BASE_OFF];
        }
        local = (hdr & KIND_LOCAL) != 0;
        if (local) {
            eo = inst.iorg;
            ed = inst.idir;
            ei = inst.iinv;
            en = inst.inoid;
        }
    }

    if (is_cluster) {
        // ---- Moller-Trumbore on every triangle of the cluster ----
        float qo[3], qs[3];
        for (int k = 0; k < 3; ++k) {
            qo[k] = __uint_as_float(row[QORIGIN_OFF + k]);
            qs[k] = __uint_as_float(row[QSCALE_OFF + k]);
        }
        float cl = CUDART_INF_F;
        int slot = -1;
        float nc[3] = {0.0f, 0.0f, 0.0f};
        for (int j = 0; j < BRANCH; ++j) {
            // slot j's u16 is the low half of word j (j < 32) or the
            // high half of word j - 32
            float v[9];
            for (int c = 0; c < 9; ++c) {
                const uint32_t w = row[QVERT_OFF + c * QVERT_WORDS
                                       + (j & (QVERT_WORDS - 1))];
                const uint32_t q = j < QVERT_WORDS ? (w & 0xFFFFu)
                                                   : (w >> 16);
                v[c] = (float)q * qs[c % 3] + qo[c % 3];
            }
            float e1[3], e2[3], sv[3];
            for (int k = 0; k < 3; ++k) {
                e1[k] = v[3 + k] - v[k];
                e2[k] = v[6 + k] - v[k];
                sv[k] = eo[k] - v[k];
            }
            const float h0 = ed[1] * e2[2] - ed[2] * e2[1];
            const float h1 = ed[2] * e2[0] - ed[0] * e2[2];
            const float h2 = ed[0] * e2[1] - ed[1] * e2[0];
            const float a = e1[0] * h0 + e1[1] * h1 + e1[2] * h2;
            const bool not_par = fabsf(a) > FLT_EPS;
            const float f = 1.0f / (not_par ? a : 1.0f);
            const float u = f * (sv[0] * h0 + sv[1] * h1 + sv[2] * h2);
            const float q0 = sv[1] * e1[2] - sv[2] * e1[1];
            const float q1 = sv[2] * e1[0] - sv[0] * e1[2];
            const float q2 = sv[0] * e1[1] - sv[1] * e1[0];
            const float vb = f * (ed[0] * q0 + ed[1] * q1 + ed[2] * q2);
            const float t = f * (e2[0] * q0 + e2[1] * q1 + e2[2] * q2);
            const bool hitj = not_par && u >= -EPS && u <= ONE_EPS
                && vb >= -EPS && u + vb <= ONE_EPS && t > EPS;
            int32_t tid = (int32_t)row[TRI_ID_OFF + j];
            if (INSTANCED && local) tid += inst.tbase;
            if (hitj && j < count && tid != lht && t < cl) {
                cl = t;
                slot = j;
                nc[0] = e1[1] * e2[2] - e1[2] * e2[1];
                nc[1] = e1[2] * e2[0] - e1[0] * e2[2];
                nc[2] = e1[0] * e2[1] - e1[1] * e2[0];
            }
        }
        if (cl < hit.min_dist) {
            hit.min_dist = cl;
            int32_t tid = (int32_t)row[TRI_ID_OFF + slot];
            if (INSTANCED && local) tid += inst.tbase;
            hit.tri = tid;
            hit.mat = row[MAT_OFF + slot];
            // the TPU kernel picks by a one-hot sum, so -0.0 reads +0.0
            float nl[3] = {nc[0] + 0.0f, nc[1] + 0.0f, nc[2] + 0.0f};
            if (INSTANCED && local) {
                for (int r = 0; r < 3; ++r)
                    hit.nrm[r] = inst.irot[3 * r] * nl[0]
                        + inst.irot[3 * r + 1] * nl[1]
                        + inst.irot[3 * r + 2] * nl[2];
            } else {
                for (int r = 0; r < 3; ++r) hit.nrm[r] = nl[r];
            }
        }
    } else {
        // ---- internal row: slab-test the children, push a level ----
        uint16_t nc[BRANCH];
        uint32_t mn = SENT;
        for (int j = 0; j < BRANCH; ++j) {
            float tmin, tmax;
            slab(row, j, ei, en, &tmin, &tmax);
            const bool ok = (tmin <= tmax) && (tmin <= hit.min_dist)
                && (j < count);
            const uint32_t code =
                ok ? (uint32_t)clip_code(floorf(tmin * sq)) : SENT;
            nc[j] = (uint16_t)code;
            mn = code < mn ? code : mn;
        }
        if (mn < SENT && lvl + 1 < depth) {
            for (int j = 0; j < BRANCH; ++j) pend.tc[lvl][j] = nc[j];
            pend.bases[lvl] = row[HDR_BASE];
        }
    }
}

// Pop the nearest pending child of the deepest live level.  Sets *lvl
// (-1 when nothing is live) and *ptr (0 then); returns whether a child
// was popped.
__device__ __forceinline__ bool pop(Pending& pend, int nslots,
                                    float min_dist, float sq, int* lvl,
                                    uint32_t* ptr) {
    const uint32_t thresh =
        (uint32_t)clip_code(floorf(min_dist * sq) + 1.0f);
    int new_lvl = -1;
    uint32_t m = SENT;
    for (int s = nslots - 1; s >= 0; --s) {
        uint32_t ms = SENT;
        for (int j = 0; j < BRANCH; ++j)
            ms = pend.tc[s][j] < ms ? pend.tc[s][j] : ms;
        if (ms <= thresh) {
            new_lvl = s + 1;
            m = ms;
            break;
        }
    }
    *lvl = new_lvl;
    if (new_lvl < 0) {
        *ptr = 0;
        return false;
    }
    const int s = new_lvl - 1;
    int c = 0;
    while (pend.tc[s][c] != m) ++c;
    pend.tc[s][c] = (uint16_t)SENT;
    *ptr = pend.bases[s] + (uint32_t)c;
    return true;
}

}  // namespace mbvh

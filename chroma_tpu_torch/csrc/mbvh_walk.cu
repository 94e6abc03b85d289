// Closest-hit MBVH walk: one thread per ray, the whole walk in one launch.
//
// Replaces the TPU walker kernel of chroma_tpu/ops/mbvh_pallas.py
// (`_make_kernel`, launched per iteration by `walk_iter`) together with
// its host loop `intersect_mesh_pallas` (`seed`, then `walk_iter` until no
// lane is active, then `results`).  K1 (flat) and K2 (TLAS/BLAS
// instanced) are the two instantiations of the template below.
//
// Semantics are those of the TPU kernel, step for step: nearest-first
// pops on 16-bit quantized entry distances, a level is live while its
// nearest pending code can still beat floor(min_dist*sq)+1, the deepest
// live level is popped, ties go to the lowest slot, the improvement test
// is strict.  Codes are kept unbiased here (0..65534 pending, 65535 =
// absent or popped); the TPU kernel biases them by 32768 to fit int16,
// which preserves every comparison.
//
// What bounds it on an H100: each visited row is a dependent 1,696-byte
// read from device memory (rows are gathered per thread, not per warp),
// and the 11x64 pending codes live in local memory.  This first version
// keeps the structure simple and exact; warp-per-ray rows and
// shared-memory staging are later work.
//
// Floating point: built with --fmad=false and without fast math so every
// a*b+c rounds twice, as the plain PyTorch version in
// chroma_tpu_torch/ops/mbvh_walk.py computes it; results are bit-equal.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// Row layout of chroma_tpu/bvh/mbvh.py at BRANCH = 64 (the Python
// wrapper checks that the packed tables use exactly this layout).
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

// Slab test of child box j of an internal row against a ray given as
// 1/dir and -org/dir.  Axes with infinite 1/dir are skipped.
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
        const float t0 = lo * inv[k] + noid[k];
        const float t1 = hi * inv[k] + noid[k];
        const bool fin = isfinite(inv[k]);
        const float small = fin ? min_nan(t0, t1) : -CUDART_INF_F;
        const float big = fin ? max_nan(t0, t1) : CUDART_INF_F;
        tmin = k == 0 ? small : max_nan(tmin, small);
        tmax = k == 0 ? big : min_nan(tmax, big);
    }
    *tmin_out = max_nan(tmin, 0.0f);
    *tmax_out = tmax;
}

template <bool INSTANCED>
__global__ void __launch_bounds__(128)
closest_hit_kernel(const uint32_t* __restrict__ rows,
                   const float* __restrict__ org_in,
                   const float* __restrict__ dir_in,
                   const int32_t* __restrict__ lht_in,
                   const uint8_t* __restrict__ active_in, int n, float sq,
                   int depth, int max_iters, int32_t* __restrict__ tri_out,
                   float* __restrict__ dist_out, float* __restrict__ nrm_out,
                   int32_t* __restrict__ mat_out,
                   uint8_t* __restrict__ inc_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    float o[3], d[3], inv[3], noid[3];
    for (int k = 0; k < 3; ++k) {
        o[k] = org_in[3 * i + k];
        d[k] = dir_in[3 * i + k];
        inv[k] = 1.0f / d[k];
        noid[k] = -o[k] * inv[k];
    }
    const int32_t lht = lht_in[i];
    const int nslots = depth - 1 > 1 ? depth - 1 : 1;

    // slot s holds tree level s + 1 (level 0, the root, is never pending)
    uint16_t tc[MAX_SLOTS][BRANCH];
    uint32_t bases[MAX_SLOTS];
    for (int s = 0; s < nslots; ++s) {
        bases[s] = 0;
        for (int j = 0; j < BRANCH; ++j) tc[s][j] = (uint16_t)SENT;
    }

    // ---- seed: slab-test the root's children and pop the nearest ----
    bool act = active_in[i] != 0;
    int lvl = 0;
    uint32_t ptr = 0;
    if (depth >= 2) {
        const uint32_t* root = rows;
        const int count = (int)(root[HDR_KIND] >> 8);
        uint32_t best = SENT + 1;
        int c = BRANCH;
        for (int j = 0; j < BRANCH; ++j) {
            float tmin, tmax;
            slab(root, j, inv, noid, &tmin, &tmax);
            const bool ok = (tmin <= tmax) && (j < count) && act;
            const uint32_t code =
                ok ? (uint32_t)clip_code(floorf(tmin * sq)) : SENT;
            tc[0][j] = (uint16_t)code;
            if (ok && code < best) {
                best = code;
                c = j;
            }
        }
        act = c < BRANCH;
        if (act) tc[0][c] = (uint16_t)SENT;
        bases[0] = root[HDR_BASE];
        ptr = act ? root[HDR_BASE] + (uint32_t)c : 0u;
        lvl = 1;
    }

    float min_dist = CUDART_INF_F;
    float best_nrm[3] = {0.0f, 0.0f, 0.0f};
    int32_t best_tri = -1;
    uint32_t best_mat = 0;
    // instance frame (only read on KIND_LOCAL rows, which are reachable
    // only after an entry row set it)
    float irot[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    float iorg[3] = {0, 0, 0}, idir[3] = {1, 1, 1};
    float iinv[3] = {1, 1, 1}, inoid[3] = {0, 0, 0};
    int32_t tri_base = 0;

    for (int it = 0; it < max_iters && act; ++it) {
        const uint32_t* row = rows + (size_t)ptr * ROW_WIDTH;
        const uint32_t hdr = row[HDR_KIND];
        const int count = (int)(hdr >> 8);
        const bool is_cluster = (hdr & KIND_CLUSTER) != 0;

        const float* eo = o;
        const float* ed = d;
        const float* ei = inv;
        const float* en = noid;
        bool local = false;
        if (INSTANCED) {
            if (hdr & KIND_ENTRY) {
                float xf[12];
                for (int k = 0; k < 12; ++k)
                    xf[k] = __uint_as_float(row[XFORM_OFF + k]);
                float omt[3];
                for (int r = 0; r < 3; ++r) omt[r] = o[r] - xf[9 + r];
                for (int k = 0; k < 3; ++k) {
                    iorg[k] = xf[k] * omt[0] + xf[3 + k] * omt[1]
                        + xf[6 + k] * omt[2];
                    idir[k] = xf[k] * d[0] + xf[3 + k] * d[1]
                        + xf[6 + k] * d[2];
                }
                for (int k = 0; k < 3; ++k) {
                    iinv[k] = 1.0f / idir[k];
                    inoid[k] = -iorg[k] * iinv[k];
                }
                for (int k = 0; k < 9; ++k) irot[k] = xf[k];
                tri_base = (int32_t)row[TRI_BASE_OFF];
            }
            local = (hdr & KIND_LOCAL) != 0;
            if (local) {
                eo = iorg;
                ed = idir;
                ei = iinv;
                en = inoid;
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
                const bool hit = not_par && u >= -EPS && u <= ONE_EPS
                    && vb >= -EPS && u + vb <= ONE_EPS && t > EPS;
                int32_t tid = (int32_t)row[TRI_ID_OFF + j];
                if (INSTANCED && local) tid += tri_base;
                if (hit && j < count && tid != lht && t < cl) {
                    cl = t;
                    slot = j;
                    nc[0] = e1[1] * e2[2] - e1[2] * e2[1];
                    nc[1] = e1[2] * e2[0] - e1[0] * e2[2];
                    nc[2] = e1[0] * e2[1] - e1[1] * e2[0];
                }
            }
            if (cl < min_dist) {
                min_dist = cl;
                int32_t tid = (int32_t)row[TRI_ID_OFF + slot];
                if (INSTANCED && local) tid += tri_base;
                best_tri = tid;
                best_mat = row[MAT_OFF + slot];
                // the TPU kernel picks by a one-hot sum, so -0.0 reads +0.0
                float nl[3] = {nc[0] + 0.0f, nc[1] + 0.0f, nc[2] + 0.0f};
                if (INSTANCED && local) {
                    for (int r = 0; r < 3; ++r)
                        best_nrm[r] = irot[3 * r] * nl[0]
                            + irot[3 * r + 1] * nl[1]
                            + irot[3 * r + 2] * nl[2];
                } else {
                    for (int r = 0; r < 3; ++r) best_nrm[r] = nl[r];
                }
            }
        } else {
            // ---- internal row: slab-test the children, push a level ----
            uint16_t nc[BRANCH];
            uint32_t mn = SENT;
            for (int j = 0; j < BRANCH; ++j) {
                float tmin, tmax;
                slab(row, j, ei, en, &tmin, &tmax);
                const bool ok = (tmin <= tmax) && (tmin <= min_dist)
                    && (j < count);
                const uint32_t code =
                    ok ? (uint32_t)clip_code(floorf(tmin * sq)) : SENT;
                nc[j] = (uint16_t)code;
                mn = code < mn ? code : mn;
            }
            if (mn < SENT && lvl + 1 < depth) {
                for (int j = 0; j < BRANCH; ++j) tc[lvl][j] = nc[j];
                bases[lvl] = row[HDR_BASE];
            }
        }

        // ---- pop the nearest pending child of the deepest live level ----
        const uint32_t thresh =
            (uint32_t)clip_code(floorf(min_dist * sq) + 1.0f);
        int new_lvl = -1;
        uint32_t m = SENT;
        for (int s = nslots - 1; s >= 0; --s) {
            uint32_t ms = SENT;
            for (int j = 0; j < BRANCH; ++j)
                ms = tc[s][j] < ms ? tc[s][j] : ms;
            if (ms <= thresh) {
                new_lvl = s + 1;
                m = ms;
                break;
            }
        }
        act = new_lvl >= 0;
        lvl = new_lvl;
        if (act) {
            const int s = new_lvl - 1;
            int c = 0;
            while (tc[s][c] != m) ++c;
            tc[s][c] = (uint16_t)SENT;
            ptr = bases[s] + (uint32_t)c;
        } else {
            ptr = 0;
        }
    }

    tri_out[i] = best_tri;
    dist_out[i] = min_dist;
    for (int k = 0; k < 3; ++k) nrm_out[3 * i + k] = best_nrm[k];
    mat_out[i] = (int32_t)best_mat;
    inc_out[i] = act ? 1 : 0;
}

template <bool INSTANCED>
void launch(const void* rows, const void* org, const void* dir,
            const void* lht, const void* active, int n, float sq,
            int depth, int max_iters, void* triangle, void* distance,
            void* normal, void* material_code, void* incomplete,
            cudaStream_t stream) {
    const int block = 128;
    const int grid = (n + block - 1) / block;
    closest_hit_kernel<INSTANCED><<<grid, block, 0, stream>>>(
        static_cast<const uint32_t*>(rows), static_cast<const float*>(org),
        static_cast<const float*>(dir), static_cast<const int32_t*>(lht),
        static_cast<const uint8_t*>(active), n, sq, depth, max_iters,
        static_cast<int32_t*>(triangle), static_cast<float*>(distance),
        static_cast<float*>(normal), static_cast<int32_t*>(material_code),
        static_cast<uint8_t*>(incomplete));
}

}  // namespace

// C entry point: every pointer is a device pointer, `stream` the CUDA
// stream to launch on.  Returns the cudaError_t of the launch.
extern "C" int mbvh_closest_hit(const void* rows, const void* org,
                                const void* dir, const void* lht,
                                const void* active, int n, float sq,
                                int depth, int instanced, int max_iters,
                                void* triangle, void* distance,
                                void* normal, void* material_code,
                                void* incomplete, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    if (depth < 1 || depth > MAX_SLOTS + 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (instanced)
        launch<true>(rows, org, dir, lht, active, n, sq, depth, max_iters,
                     triangle, distance, normal, material_code, incomplete, s);
    else
        launch<false>(rows, org, dir, lht, active, n, sq, depth, max_iters,
                      triangle, distance, normal, material_code, incomplete,
                      s);
    return (int)cudaGetLastError();
}

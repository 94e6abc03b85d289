// One MBVH walk iteration as __device__ functions for one group of G = 32
// threads (a warp) walking one ray together, shared by the walker
// kernels of this directory:
//
//   mbvh_walk.cu         closest_hit_kernel<INSTANCED>: one warp runs
//                        a ray's whole walk in one launch (K1, K2);
//   mbvh_walk_window.cu  walk_window_kernel<INSTANCED, OD_SLOTS>:
//                        one warp runs n_iters iterations of a lane whose
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
// The group design.  Thread t of a warp owns children t and t + 32 of
// every row (BRANCH = 64 = 2 G):
//   * row reads are coalesced across the warp: the box words
//     BOX_OFF + k*64 + j, the quantized-vertex word QVERT_OFF + c*32 + t
//     (it carries the u16 of triangle t in its low half and of t + 32 in
//     its high half: the table's own layout), TRI_ID_OFF + j, and
//     MAT_OFF only for the winner.  Header words and the instance
//     transform are read by every thread at one address (a broadcast);
//   * each thread tests its two children with exactly the per-child
//     arithmetic of the one-thread version, then the warp takes the
//     nearest: the minimum distance by one __reduce_min_sync on the
//     float bits (every candidate is > EPS > 0, and +inf, so the bits
//     order as u32), then the lowest slot at that distance by a second
//     one (each thread offers its own lowest slot at its minimum), and
//     the owner broadcasts triangle and normal with __shfl_sync;
//   * the pending codes live in registers: one u32 a level a thread
//     (its two u16 codes), for MAX_SLOTS levels, every level index a
//     compile-time constant of a fully unrolled loop with a predicate
//     (levels past the tree's depth are skipped), so no array is indexed at
//     run time; a level's base row, the hit normal and the instance
//     rotation are held once across the warp (thread k, component k);
//   * a pop is one __reduce_or_sync of the per-thread live-level bits
//     (the deepest set bit is the level) and one __reduce_min_sync of
//     (code << 6) | slot over that level, which gives the nearest code
//     and, among equal codes, the lowest slot (mbvh_pallas.py:383-385).
// Every value that steers control flow (ray, hit distance, instance
// frame, the popped row) is the same in all 32 threads, so the warp never
// diverges between walk lengths or row kinds, and a ray's exits are the
// warp's exits.
//
// Floating point: built with --fmad=false and without fast math so every
// a*b+c rounds twice, as the plain PyTorch version in
// chroma_tpu_torch/ops/mbvh_walk.py computes it; results are bit-equal.
// The reductions are exact (min, or), so the group changes no bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace mbvh {

// Row layout of chroma_tpu_torch/bvh/mbvh.py at BRANCH = 64 (the Python
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
constexpr uint32_t SENT2 = 0xFFFFFFFFu;  // a pending word, both halves SENT
constexpr float EPS = 1e-6f;
constexpr float ONE_EPS = (float)(1.0 + 1e-6);
constexpr float FLT_EPS = 1.1920929e-07f;

// Threads that walk one ray: a whole warp.
constexpr int G = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
// Threads a block: 4 rays (a block's slot frees when its longest walk
// ends, so small blocks waste less at the tail).
constexpr int BLOCK = 128;
// Blocks an SM must hold at once (__launch_bounds__): 8 x 128 threads
// cap a thread at 64 registers, so 32 warps, 32 rays, walk on each SM at
// a time.  Measured on an H100 (PERF.md, Findings), 64 registers
// beat 48 (more spills) and 80 and 128 (fewer rays in flight); the
// spills this cap costs (ptxas, in the kernels' notes) go through L1.
constexpr int MIN_BLOCKS = 8;

static_assert(MAT_OFF + BRANCH == ROW_WIDTH, "row layout");
static_assert(TRI_BASE_OFF + 1 <= ROW_WIDTH, "row layout");
static_assert(BRANCH == 2 * G && QVERT_WORDS == G,
              "thread t owns children t and t + G");
static_assert(BLOCK % G == 0, "whole warps a block");

__device__ __forceinline__ int lane_id() { return (int)(threadIdx.x & 31); }

// The ray (lane) a warp walks.
__device__ __forceinline__ long long group_index() {
    return ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
}

// jnp.minimum / jnp.maximum propagate NaN; fminf / fmaxf do not.
// min.NaN / max.NaN (sm_80 and later) return the canonical NaN when an
// input is NaN and otherwise what min / max (fminf / fmaxf) return, in
// one instruction.
__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
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
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        r.o[k] = o[k];
        r.d[k] = d[k];
        r.inv[k] = 1.0f / d[k];
        r.noid[k] = -r.o[k] * r.inv[k];
    }
}

// The best hit so far.  The normal, read only when the walk ends, is
// held once across the warp: thread k < 3 holds component k.
struct Hit {
    float min_dist;
    float nrm;
    int32_t tri;
    uint32_t mat;
};

__device__ __forceinline__ void clear_hit(Hit& h) {
    h.min_dist = CUDART_INF_F;
    h.nrm = 0.0f;
    h.tri = -1;
    h.mat = 0;
}

// Instance frame of an instanced walk, set by the last entry row (only
// read on KIND_LOCAL rows, which are reachable only after an entry row).
// The rotation, read only when a hit improves, is held once: thread
// k < 9 holds element k (row-major, local to world).
struct Inst {
    float irot, iorg[3], idir[3], iinv[3], inoid[3];
    int32_t tbase;
};

// Pending sets of one thread: tc[s] holds the u16 codes of children t
// (low half) and t + G (high half) of level slot s, which is tree level
// s + 1 (level 0, the root, is never pending).  The row id of level slot
// s's child 0 is held once, by thread s (`base`), and read with a
// shuffle.
struct Pending {
    static_assert(MAX_SLOTS <= G, "one thread holds each level's base");
    uint32_t tc[MAX_SLOTS];
    uint32_t base;
};

__device__ __forceinline__ void clear_pending(Pending& p) {
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s) p.tc[s] = SENT2;
    p.base = 0;
}

// Level s of a per-level register array, with s known only at run time:
// fully unrolled and predicated, so every index is a constant and the
// array stays in registers.  (A loop that breaks at s compiles to a[s],
// a dynamic index, and puts the array in local memory.)
__device__ __forceinline__ uint32_t get_level(
    const uint32_t (&a)[MAX_SLOTS], int s) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < MAX_SLOTS; ++k)
        if (k == s) v = a[k];
    return v;
}

__device__ __forceinline__ void set_level(uint32_t (&a)[MAX_SLOTS], int s,
                                          uint32_t v) {
#pragma unroll
    for (int k = 0; k < MAX_SLOTS; ++k)
        if (k == s) a[k] = v;
}

// The row id of level slot s's child 0.
__device__ __forceinline__ uint32_t level_base(const Pending& p, int s) {
    return __shfl_sync(FULL, p.base, s);
}

__device__ __forceinline__ void set_level_base(Pending& p, int s,
                                               uint32_t base) {
    if (lane_id() == s) p.base = base;
}

__device__ __forceinline__ uint32_t pack2(uint32_t lo, uint32_t hi) {
    return lo | (hi << 16);
}

// The warp's nearest pending child of one level word: the minimum of
// (code << 6) | slot, so equal codes go to the lowest slot.
__device__ __forceinline__ uint32_t nearest_key(uint32_t w) {
    const uint32_t t = (uint32_t)lane_id();
    const uint32_t k0 = ((w & 0xFFFFu) << 6) | t;
    const uint32_t k1 = ((w >> 16) << 6) | (t + G);
    return __reduce_min_sync(FULL, k0 < k1 ? k0 : k1);
}

// A level word with child c's code set to SENT (only its owner changes).
__device__ __forceinline__ uint32_t clear_slot(uint32_t w, int c) {
    const int t = lane_id();
    if (c == t) w |= 0xFFFFu;
    if (c == t + G) w |= 0xFFFF0000u;
    return w;
}

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

// The dequantization grid of an internal row's child boxes.
struct BoxGrid {
    float bo[3], bs[3];
};

__device__ __forceinline__ BoxGrid box_grid(const uint32_t* row) {
    BoxGrid g;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        g.bo[k] = __uint_as_float(row[IBOX_ORIGIN_OFF + k]);
        g.bs[k] = __uint_as_float(row[IBOX_SCALE_OFF + k]);
    }
    return g;
}

// Slab test of child box j of an internal row (quantized boxes).
__device__ __forceinline__ void slab(const uint32_t* row, const BoxGrid& g,
                                     int j, const float* inv,
                                     const float* noid, float* tmin_out,
                                     float* tmax_out) {
    float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const uint32_t pk = row[BOX_OFF + k * BRANCH + j];
        const float lo = g.bo[k] + (float)(pk & 0xFFFFu) * g.bs[k];
        const float hi = g.bo[k] + (float)(pk >> 16) * g.bs[k];
        slab_axis(k, lo, hi, inv[k], noid[k], &tmin, &tmax);
    }
    *tmin_out = max_nan(tmin, 0.0f);
    *tmax_out = tmax;
}

// Slab test of root child j from the dequantized boxes `lohi` in device
// memory ([lo_x | hi_x | lo_y | hi_y | lo_z | hi_z], BRANCH each; the
// same values `slab` computes from the root row).
__device__ __forceinline__ void slab_lohi(const float* __restrict__ lohi,
                                          int j, const float* inv,
                                          const float* noid,
                                          float* tmin_out, float* tmax_out) {
    float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
        slab_axis(k, __ldg(lohi + (2 * k) * BRANCH + j),
                  __ldg(lohi + (2 * k + 1) * BRANCH + j), inv[k], noid[k],
                  &tmin, &tmax);
    *tmin_out = max_nan(tmin, 0.0f);
    *tmax_out = tmax;
}

// Root seed: the root's children slab-tested into slot 0 and the
// nearest one popped (ties to the lowest slot).  Children come from
// the root row (`root` non-null) or from its dequantized boxes `lohi`.
// Returns whether a child was popped; sets tc0 and ptr (0 when none).
__device__ __forceinline__ bool seed_root(const uint32_t* root,
                                          const float* lohi, int count,
                                          uint32_t base, const Ray& ray,
                                          float sq, bool active,
                                          uint32_t& tc0, uint32_t& ptr) {
    const int t = lane_id();
    BoxGrid g = {};
    if (root) g = box_grid(root);
    uint32_t code[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int j = t + h * G;
        float tmin, tmax;
        if (root)
            slab(root, g, j, ray.inv, ray.noid, &tmin, &tmax);
        else
            slab_lohi(lohi, j, ray.inv, ray.noid, &tmin, &tmax);
        const bool ok = (tmin <= tmax) && (j < count) && active;
        code[h] = ok ? (uint32_t)clip_code(floorf(tmin * sq)) : SENT;
    }
    uint32_t w = pack2(code[0], code[1]);
    const uint32_t key = nearest_key(w);
    const bool act = (key >> 6) < SENT;
    const int c = (int)(key & 63u);
    if (act) w = clear_slot(w, c);
    tc0 = w;
    ptr = act ? base + (uint32_t)c : 0u;
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
    const int t = lane_id();
    const uint32_t hdr = row[HDR_KIND];
    const int count = (int)(hdr >> 8);
    const bool is_cluster = (hdr & KIND_CLUSTER) != 0;

    bool local = false;
    if (INSTANCED) {
        if (hdr & KIND_ENTRY) {
            float xf[12];
#pragma unroll
            for (int k = 0; k < 12; ++k)
                xf[k] = __uint_as_float(row[XFORM_OFF + k]);
            float omt[3];
#pragma unroll
            for (int r = 0; r < 3; ++r) omt[r] = ray.o[r] - xf[9 + r];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                inst.iorg[k] = xf[k] * omt[0] + xf[3 + k] * omt[1]
                    + xf[6 + k] * omt[2];
                inst.idir[k] = xf[k] * ray.d[0] + xf[3 + k] * ray.d[1]
                    + xf[6 + k] * ray.d[2];
            }
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                inst.iinv[k] = 1.0f / inst.idir[k];
                inst.inoid[k] = -inst.iorg[k] * inst.iinv[k];
            }
            inst.irot = __uint_as_float(row[XFORM_OFF + (t < 9 ? t : 8)]);
            inst.tbase = (int32_t)row[TRI_BASE_OFF];
        }
        local = (hdr & KIND_LOCAL) != 0;
    }
    // the ray the row is tested with: the instance frame's on LOCAL
    // rows (selected by value: a pointer to either array would put both
    // in local memory)
    float eo[3], ed[3], ei[3], en[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        eo[k] = local ? inst.iorg[k] : ray.o[k];
        ed[k] = local ? inst.idir[k] : ray.d[k];
        ei[k] = local ? inst.iinv[k] : ray.inv[k];
        en[k] = local ? inst.inoid[k] : ray.noid[k];
    }

    if (is_cluster) {
        // ---- Moller-Trumbore on this thread's two triangles ----
        float qo[3], qs[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            qo[k] = __uint_as_float(row[QORIGIN_OFF + k]);
            qs[k] = __uint_as_float(row[QSCALE_OFF + k]);
        }
        // word t of each component: triangle t (low), t + G (high)
        uint32_t qw[9];
#pragma unroll
        for (int c = 0; c < 9; ++c)
            qw[c] = row[QVERT_OFF + c * QVERT_WORDS + t];
        float cl = CUDART_INF_F;
        int slot = BRANCH;
        int32_t ctid = 0;
        float nc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int j = t + h * G;
            float v[9];
#pragma unroll
            for (int c = 0; c < 9; ++c) {
                const uint32_t q = h ? (qw[c] >> 16) : (qw[c] & 0xFFFFu);
                v[c] = (float)q * qs[c % 3] + qo[c % 3];
            }
            float e1[3], e2[3], sv[3];
#pragma unroll
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
            const float td = f * (e2[0] * q0 + e2[1] * q1 + e2[2] * q2);
            const bool hitj = not_par && u >= -EPS && u <= ONE_EPS
                && vb >= -EPS && u + vb <= ONE_EPS && td > EPS;
            int32_t tid = (int32_t)row[TRI_ID_OFF + j];
            if (INSTANCED && local) tid += inst.tbase;
            if (hitj && j < count && tid != lht && td < cl) {
                cl = td;
                slot = j;
                ctid = tid;
                nc[0] = e1[1] * e2[2] - e1[2] * e2[1];
                nc[1] = e1[2] * e2[0] - e1[0] * e2[2];
                nc[2] = e1[0] * e2[1] - e1[1] * e2[0];
            }
        }
        // the warp's nearest distance, then the lowest slot at it
        const uint32_t cbits = __float_as_uint(cl);
        const uint32_t mbits = __reduce_min_sync(FULL, cbits);
        const int win = (int)__reduce_min_sync(
            FULL, cbits == mbits ? (uint32_t)slot : (uint32_t)BRANCH);
        const int owner = win & (G - 1);
        const int32_t wtid = __shfl_sync(FULL, ctid, owner);
        float wn[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) wn[k] = __shfl_sync(FULL, nc[k], owner);
        const float wdist = __uint_as_float(mbits);
        if (wdist < hit.min_dist) {
            hit.min_dist = wdist;
            hit.tri = wtid;
            hit.mat = row[MAT_OFF + win];
            // the TPU kernel picks by a one-hot sum, so -0.0 reads +0.0
            const float nl[3] = {wn[0] + 0.0f, wn[1] + 0.0f, wn[2] + 0.0f};
            if (INSTANCED && local) {
                // thread r < 3: row r of the rotation, from threads 3r..3r+2
                const int r3 = 3 * (t < 3 ? t : 0);
                const float a = __shfl_sync(FULL, inst.irot, r3);
                const float b = __shfl_sync(FULL, inst.irot, r3 + 1);
                const float c = __shfl_sync(FULL, inst.irot, r3 + 2);
                hit.nrm = a * nl[0] + b * nl[1] + c * nl[2];
            } else {
                hit.nrm = t == 0 ? nl[0] : (t == 1 ? nl[1] : nl[2]);
            }
        }
    } else {
        // ---- internal row: slab-test the children, push a level ----
        const BoxGrid g = box_grid(row);
        uint32_t code[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int j = t + h * G;
            float tmin, tmax;
            slab(row, g, j, ei, en, &tmin, &tmax);
            const bool ok = (tmin <= tmax) && (tmin <= hit.min_dist)
                && (j < count);
            code[h] = ok ? (uint32_t)clip_code(floorf(tmin * sq)) : SENT;
        }
        const uint32_t mn = __reduce_min_sync(
            FULL, code[0] < code[1] ? code[0] : code[1]);
        if (mn < SENT && lvl + 1 < depth) {
            set_level(pend.tc, lvl, pack2(code[0], code[1]));
            set_level_base(pend, lvl, row[HDR_BASE]);
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
    uint32_t live = 0;
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s) {
        if (s >= nslots) break;
        const uint32_t w = pend.tc[s];
        if ((w & 0xFFFFu) <= thresh || (w >> 16) <= thresh) live |= 1u << s;
    }
    live = __reduce_or_sync(FULL, live);
    if (live == 0) {
        *lvl = -1;
        *ptr = 0;
        return false;
    }
    const int s = 31 - __clz(live);
    const uint32_t w = get_level(pend.tc, s);
    const uint32_t key = nearest_key(w);
    const int c = (int)(key & 63u);
    set_level(pend.tc, s, clear_slot(w, c));
    *lvl = s + 1;
    *ptr = level_base(pend, s) + (uint32_t)c;
    return true;
}

}  // namespace mbvh

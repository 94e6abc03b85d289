// On-deck walker window: n_iters MBVH walk iterations per lane, with
// the drain-restart cascade, one warp per lane.
//
// Replaces the on-deck variants of the TPU walker kernel of
// chroma_tpu/ops/mbvh_pallas.py (`_make_kernel(ondeck=True)`, launched
// per iteration by `walk_iter`, :557-654): K3 (od_slots = 1, :405-513)
// and K4 (od_slots = 2, :411-433 and :509-512).  The TPU driver calls
// the kernel once per iteration with the row gather outside it; here
// one launch runs a whole service window of n_iters iterations and each
// warp reads its own lane's rows.  What one iteration computes is
// exactly `walk_iter(ondeck=True)`: the row popped last is processed and
// the next child popped (mbvh_walk_core.cuh, which states the group
// design), then, in the iteration a walk drains,
//   * its results (distance, normal, triangle, material) are parked in
//     `park` (pad bit 1), or with a second slot, when `park` is taken,
//     in `park2` (pad bit 4);
//   * the lane restarts on its on-deck ray (the second slot's when
//     `park` is taken): the hit registers reset, the root's children
//     are slab-tested against the dequantized root boxes `root_lohi`
//     into slot 0 and the nearest one popped, so the restarted walk
//     costs no extra iteration; the instance registers ride through;
//   * a walk that drains with no on-deck ray left sets pad bit 2.
//
// Lane state lives in device memory across launches.  The pending codes
// `tcodes` are lanes-first, [n][S][64] int32 (S = depth - 1): one level
// of one lane is 64 contiguous words, so the warp of a lane loads and
// stores a level as two 128-byte accesses (thread t: slots t, t + 32).
// The lane-minor [S][64][n] layout of the one-thread-per-lane kernel
// would cost 32 sectors a warp access here.  The layout is the port's
// window state layout everywhere (ops/mbvh_walk.py `window_layout`: the
// plain version and the service pass in ops/fused.py carry it), not a
// transpose in the wrapper, which would move every code twice more per
// launch.  The codes stay int32, not u16: the plain version and the
// service pass do int32 arithmetic on them (torch's uint16 support on
// the CPU is partial).  Every other field stays field-major and
// lane-minor ([k][n], word w of lane i at w * n + i) and is read once
// per warp: all 32 threads read one address (a broadcast) and thread 0
// stores it, but the normal and the instance rotation, which thread k
// holds component k of.  The Python wrapper (chroma_tpu_torch/ops/mbvh_walk.py,
// `walk_window_cuda`) passes the fields as an array of device pointers
// in the order of the enum below, which is KERNEL_STATE_KEYS there.
//
// What bounds it on an H100 (counted in chip_smoke.py from the code and
// the run's own walks): bytes.  A 17-iteration window over 65,536 full-
// demo lanes reads and writes ~142 MB of lane state (the pending codes
// counted as the 16-bit codes they are, 0.64 KB a lane at S = 5, though
// they are stored as int32; ~0.3 KB of other fields a lane) for ~1.5
// GFLOP, so the bound is ~0.042 ms at 3.35 TB/s; the kernel runs at
// about 6% of it (PERF.md), bound by latency and issue like the
// closest-hit kernel.  A lane that has drained with no on-deck ray left
// is a fixed point: its warp stops iterating and stores nothing.
//
// Builds: <INSTANCED, OD_SLOTS>, each holding MAX_SLOTS pending levels
// as the closest-hit kernel.  Registers: capped at 64 by
// __launch_bounds__(BLOCK, MIN_BLOCKS), as the closest-hit kernel.
// ptxas (sm_90a, CUDA 12.8; chip_smoke.py phase 2), stack frame and
// spill stores / loads: <false, 1> 88 B, 120 B / 140 B; <false, 2> 88 B,
// 100 B / 132 B; <true, 1> 152 B, 248 B / 284 B; <true, 2> 152 B, 232 B
// / 304 B.  Spills of the cap: uncapped, the first warp-per-ray build
// ran at 98-128 registers with 0-8 B of stack, and slower.
#include "mbvh_walk_core.cuh"

namespace {

using namespace mbvh;

enum Key {
    ORG, DIR, INV, NOID, LHT, TCODES, BASES, PTR, ACT, LVL, TRI, MAT,
    MIN_DIST, NRM, TBASE, PAD,
    IROT, IORG, IDIR, IINV, INOID,                          // instanced
    OD_ORG, OD_DIR, OD_VALID, OD_LHT,                       // on-deck 1
    PARK_DIST, PARK_NRM, PARK_TRI, PARK_MAT,
    OD2_ORG, OD2_DIR, OD2_VALID, OD2_LHT,                   // on-deck 2
    PARK2_DIST, PARK2_NRM, PARK2_TRI, PARK2_MAT,
    NKEYS
};

struct State {
    void* p[NKEYS];
};

// (field, word) of lane i in a lane-minor [k][n] array
struct Lanes {
    const State& st;
    size_t n;
    size_t i;
    __device__ float& f(int key, int w = 0) const {
        return static_cast<float*>(st.p[key])[w * n + i];
    }
    __device__ int32_t& s(int key, int w = 0) const {
        return static_cast<int32_t*>(st.p[key])[w * n + i];
    }
    __device__ uint8_t& b(int key) const {
        return static_cast<uint8_t*>(st.p[key])[i];
    }
};

// Park the walk's results (thread k < 3 stores normal component k,
// thread 0 the rest).
__device__ __forceinline__ void park(const Lanes& L, int base,
                                     const Hit& hit) {
    // base is PARK_DIST or PARK2_DIST; the other fields follow it
    const int t = lane_id();
    if (t < 3) L.f(base + 1, t) = hit.nrm;
    if (t != 0) return;
    L.f(base) = hit.min_dist;
    L.s(base + 2) = hit.tri;
    L.s(base + 3) = (int32_t)hit.mat;
}

template <bool INSTANCED, int OD_SLOTS>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
walk_window_kernel(const uint32_t* __restrict__ rows, State st, int n,
                   float sq, int depth, int n_iters, uint32_t rbase,
                   int rcount, const float* __restrict__ root_lohi) {
    // one warp per lane: a warp past the ragged edge leaves whole
    const long long gi = group_index();
    if (gi >= n) return;
    const int t = lane_id();
    const Lanes L{st, (size_t)n, (size_t)gi};
    const int nslots = depth - 1 > 1 ? depth - 1 : 1;
    int32_t* tcg = static_cast<int32_t*>(st.p[TCODES])
        + (size_t)gi * nslots * BRANCH;

    // ---- load the lane ----
    Ray ray;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        ray.o[k] = L.f(ORG, k);
        ray.d[k] = L.f(DIR, k);
        ray.inv[k] = L.f(INV, k);
        ray.noid[k] = L.f(NOID, k);
    }
    int32_t lht = L.s(LHT);
    Pending pend;
    clear_pending(pend);
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s) {
        if (s >= nslots) break;
        pend.tc[s] = pack2((uint32_t)tcg[s * BRANCH + t],
                           (uint32_t)tcg[s * BRANCH + t + G]);
    }
    if (t < nslots) pend.base = (uint32_t)L.s(BASES, t);
    uint32_t ptr = (uint32_t)L.s(PTR);
    bool act = L.b(ACT) != 0;
    int lvl = L.s(LVL);
    Hit hit;
    hit.min_dist = L.f(MIN_DIST);
    hit.nrm = t < 3 ? L.f(NRM, t) : 0.0f;
    hit.tri = L.s(TRI);
    hit.mat = (uint32_t)L.s(MAT);
    Inst inst;
    inst.tbase = L.s(TBASE);
    if (INSTANCED) {
        inst.irot = t < 9 ? L.f(IROT, t) : 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            inst.iorg[k] = L.f(IORG, k);
            inst.idir[k] = L.f(IDIR, k);
            inst.iinv[k] = L.f(IINV, k);
            inst.inoid[k] = L.f(INOID, k);
        }
    }
    int32_t pad = L.s(PAD);
    const bool od_valid = L.b(OD_VALID) != 0;
    const bool od2_valid = OD_SLOTS == 2 && L.b(OD2_VALID) != 0;

    bool changed = false;
    for (int it = 0; it < n_iters; ++it) {
        const bool parked = (pad & 1) != 0;
        const bool parked2 = OD_SLOTS == 2 && (pad & 4) != 0;
        if (!act && lvl < 0) {
            // drained: nothing changes unless a swap is due
            const bool due = (pad & 2) != 0
                && ((!parked && od_valid)
                    || (OD_SLOTS == 2 && parked && !parked2 && od2_valid));
            if (!due) break;
        }
        changed = true;

        const bool act_in = act;
        if (act_in)
            process_row<INSTANCED>(rows + (size_t)ptr * ROW_WIDTH, ray, lht,
                                   sq, depth, lvl, hit, inst, pend);
        act = pop(pend, nslots, hit.min_dist, sq, &lvl, &ptr);

        // ---- drain-restart cascade ----
        const bool done = (pad & 2) != 0 || (act_in && !act);
        const bool swap1 = done && !act && !parked && od_valid;
        const bool swap2 = OD_SLOTS == 2 && done && !act && parked
            && !parked2 && od2_valid;
        const bool swap = swap1 || swap2;
        if (swap1) park(L, PARK_DIST, hit);
        if (swap2) park(L, PARK2_DIST, hit);
        if (swap) {
            const int slot = swap2 ? OD2_ORG : OD_ORG;
            float o[3], d[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                o[k] = L.f(slot, k);
                d[k] = L.f(slot + 1, k);
            }
            set_ray(ray, o, d);
            lht = L.s(slot + 3);
            clear_hit(hit);
            inst.tbase = 0;
#pragma unroll
            for (int s = 1; s < MAX_SLOTS; ++s) pend.tc[s] = SENT2;
            if (depth >= 2) {
                act = seed_root(nullptr, root_lohi, rcount, rbase, ray, sq,
                                true, pend.tc[0], ptr);
                lvl = 1;
            } else {
                // the root is a single cluster row: pop it directly
                pend.tc[0] = SENT2;
                act = true;
                ptr = 0;
                lvl = 0;
            }
            set_level_base(pend, 0, rbase);
        }
        pad = ((parked || swap1) ? 1 : 0) | ((done && !swap) ? 2 : 0)
            | ((parked2 || swap2) ? 4 : 0);
    }
    if (!changed) return;

    // ---- store the lane: the codes by every thread, level slot s's base
    // by thread s, the rest by thread 0 ----
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s) {
        if (s >= nslots) break;
        tcg[s * BRANCH + t] = (int32_t)(pend.tc[s] & 0xFFFFu);
        tcg[s * BRANCH + t + G] = (int32_t)(pend.tc[s] >> 16);
    }
    if (t < nslots) L.s(BASES, t) = (int32_t)pend.base;
    if (t < 3) L.f(NRM, t) = hit.nrm;
    if (INSTANCED && t < 9) L.f(IROT, t) = inst.irot;
    if (t != 0) return;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        L.f(ORG, k) = ray.o[k];
        L.f(DIR, k) = ray.d[k];
        L.f(INV, k) = ray.inv[k];
        L.f(NOID, k) = ray.noid[k];
    }
    L.s(LHT) = lht;
    L.s(PTR) = (int32_t)ptr;
    L.b(ACT) = act ? 1 : 0;
    L.s(LVL) = lvl;
    L.f(MIN_DIST) = hit.min_dist;
    L.s(TRI) = hit.tri;
    L.s(MAT) = (int32_t)hit.mat;
    L.s(TBASE) = inst.tbase;
    if (INSTANCED) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            L.f(IORG, k) = inst.iorg[k];
            L.f(IDIR, k) = inst.idir[k];
            L.f(IINV, k) = inst.iinv[k];
            L.f(INOID, k) = inst.inoid[k];
        }
    }
    L.s(PAD) = pad;
}

template <bool INSTANCED, int OD_SLOTS>
void launch(const uint32_t* rows, const State& st, int n, float sq,
            int depth, int n_iters, uint32_t rbase, int rcount,
            const float* root_lohi, cudaStream_t stream) {
    const long long threads = (long long)n * G;
    const int grid = (int)((threads + BLOCK - 1) / BLOCK);
    walk_window_kernel<INSTANCED, OD_SLOTS><<<grid, BLOCK, 0, stream>>>(
        rows, st, n, sq, depth, n_iters, rbase, rcount, root_lohi);
}

}  // namespace

// C entry point: `state` is a host array of NKEYS device pointers in
// the order of enum Key (null where a field is absent: the instance
// registers of a flat geometry, the second slot at od_slots = 1);
// `rows` and `root_lohi` are device pointers, `stream` the CUDA stream
// to launch on; the tree's depth at most MAX_SLOTS + 1.  Returns the
// cudaError_t of the launch.
extern "C" int mbvh_walk_window(const void* rows, void* const* state,
                                int nkeys, int n, float sq, int depth,
                                int instanced, int od_slots, int n_iters,
                                int rbase, int rcount, const void* root_lohi,
                                void* stream) {
    if (nkeys != NKEYS) return (int)cudaErrorInvalidValue;
    if (n <= 0 || n_iters <= 0) return (int)cudaSuccess;
    if (depth < 1 || depth - 1 > MAX_SLOTS) return (int)cudaErrorInvalidValue;
    if (od_slots != 1 && od_slots != 2) return (int)cudaErrorInvalidValue;
    State st;
    for (int k = 0; k < NKEYS; ++k) st.p[k] = state[k];
    const uint32_t* r = static_cast<const uint32_t*>(rows);
    const float* lohi = static_cast<const float*>(root_lohi);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t rb = (uint32_t)rbase;
    if (instanced && od_slots == 2)
        launch<true, 2>(r, st, n, sq, depth, n_iters, rb, rcount, lohi, s);
    else if (instanced)
        launch<true, 1>(r, st, n, sq, depth, n_iters, rb, rcount, lohi, s);
    else if (od_slots == 2)
        launch<false, 2>(r, st, n, sq, depth, n_iters, rb, rcount, lohi, s);
    else
        launch<false, 1>(r, st, n, sq, depth, n_iters, rb, rcount, lohi, s);
    return (int)cudaGetLastError();
}

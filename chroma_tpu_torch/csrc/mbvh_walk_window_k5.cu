// Walker window without on-deck slots (K5), pruning or not (K6 on K5),
// for Hopper: persistent warps over a queue of lanes.
//
// Replaces the TPU walker kernel of chroma_tpu/ops/mbvh_pallas.py
// (`_make_kernel`, launched per iteration by `walk_iter`, :557-654) with
// ondeck=False, do_prune True or False (:352-357): the fused driver's
// window when the on-deck path is off or `service_frac` is set (then
// one iteration a launch).  One launch runs n_iters iterations of
// `walk_iter` over every lane; a drained walk (act 0, lvl < 0) idles
// until the service pass reseeds it.  One iteration is exactly
// mbvh_walk_core.cuh's `process_row` and `pop` (one warp walks one
// lane, the group design stated there), so the kernel is bit-equal to
// the plain version (ops/mbvh_walk.py `walk_window_plain`, od_slots 0)
// in every field of the state, with the same active count.  The lane
// state is mbvh_walk_state.cuh's; this kernel reads the ray and never
// writes it, nor the pad word (the TPU kernel's read-only `rays`).
//
// What bounds it on an H100 (chip_smoke.py counts it from the code and
// the run's own walks): bytes.  A 17-iteration window over 65,536
// full-demo lanes moves ~131 MB of lane state (the pending codes counted
// as 16-bit codes) for ~0.9 GFLOP: ~0.039 ms at 3.35 TB/s.  What is left
// above that is the walk's instruction latency and throughput, as in the
// other walkers (PERF.md).
//
// Persistent warps.  The grid is the SM count times the blocks an SM
// holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor, queried once a
// device by the wrapper), capped at one warp a lane.  Each warp takes
// its next lane from a device queue (one atomicAdd by thread 0,
// broadcast by __shfl_sync), runs the lane's n_iters, stores it and
// takes the next, so a warp whose walk ends short starts another at
// once, where a block of one-lane warps holds its slot until its longest
// walk ends.  The active count is one atomicAdd a warp at the end, an
// integer sum: the order of the lanes changes nothing.  A drained lane
// is a fixed point without on-deck slots: its warp loads it, runs no
// iteration and stores nothing.  The queue costs one atomic a lane on
// one word, which bounds a one-iteration launch (the `service_frac`
// window); a first kernel listing the lanes not drained speeds that
// launch 3x but slows a fresh 17-iteration window 3-4%
// (tools/ab_window_k5.py, PERF.md), so it is not used.
//
// Blocks: 16 warps (K5_BLOCK), two an SM (K5_MIN_BLOCKS): 2 x 512
// threads cap a thread at 64 registers, as the other walker kernels, so
// 32 walks run on an SM at a time.
#include "mbvh_walk_core.cuh"
#include "mbvh_walk_state.cuh"

namespace {

using namespace mbvh;

constexpr int K5_BLOCK = 512;
constexpr int K5_MIN_BLOCKS = 2;
constexpr int K5_WARPS = K5_BLOCK / G;
static_assert(K5_BLOCK % G == 0, "whole warps");

// One lane's n_iters iterations by the calling warp.  Returns the
// iterations after which its walk is active.
template <bool INSTANCED>
__device__ __forceinline__ unsigned walk_lane(
    const uint32_t* __restrict__ rows, const State& st, int n, unsigned gi,
    float sq, int depth, int nslots, int n_iters, bool prune) {
    const int t = lane_id();
    const Lanes L{st, (size_t)n, (size_t)gi};
    int32_t* tcg = static_cast<int32_t*>(st.p[TCODES])
        + (size_t)gi * nslots * BRANCH;

    // ---- load the lane ----
    bool act = L.b(ACT) != 0;
    int lvl = L.s(LVL);
    Ray ray;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        ray.o[k] = L.f(ORG, k);
        ray.d[k] = L.f(DIR, k);
        ray.inv[k] = L.f(INV, k);
        ray.noid[k] = L.f(NOID, k);
    }
    const int32_t lht = L.s(LHT);
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

    bool changed = false;
    unsigned nact = 0;
    for (int it = 0; it < n_iters; ++it) {
        if (!act && lvl < 0) break;      // drained
        changed = true;
        if (act)
            process_row<INSTANCED>(rows + (size_t)ptr * ROW_WIDTH, ray, lht,
                                   sq, depth, lvl, hit, inst, pend);
        act = pop(pend, nslots, hit.min_dist, sq, prune, &lvl, &ptr);
        nact += act;
    }
    if (!changed) return nact;

    // ---- store the lane (not the ray, the last hit or the pad word):
    // the codes by every thread, level slot s's base by thread s, the
    // rest by thread 0 ----
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s) {
        if (s >= nslots) break;
        tcg[s * BRANCH + t] = (int32_t)(pend.tc[s] & 0xFFFFu);
        tcg[s * BRANCH + t + G] = (int32_t)(pend.tc[s] >> 16);
    }
    if (t < nslots) L.s(BASES, t) = (int32_t)pend.base;
    if (t < 3) L.f(NRM, t) = hit.nrm;
    if (INSTANCED && t < 9) L.f(IROT, t) = inst.irot;
    if (t != 0) return nact;
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
    return nact;
}

// Lanes 0..n-1 from the queue `queue` (zero before the launch) until it
// runs dry.
template <bool INSTANCED>
__global__ void __launch_bounds__(K5_BLOCK, K5_MIN_BLOCKS)
walk_window_k5_kernel(const uint32_t* __restrict__ rows, State st, int n,
                      float sq, int depth, int n_iters, bool prune,
                      unsigned* __restrict__ queue,
                      unsigned long long* __restrict__ nactive) {
    const int t = lane_id();
    const int nslots = depth - 1 > 1 ? depth - 1 : 1;
    unsigned long long nact = 0;
    for (;;) {
        unsigned k = 0;
        if (t == 0) k = atomicAdd(queue, 1u);
        k = __shfl_sync(FULL, k, 0);
        if (k >= (unsigned)n) break;
        nact += walk_lane<INSTANCED>(rows, st, n, k, sq, depth, nslots,
                                     n_iters, prune);
    }
    if (nactive && t == 0 && nact) atomicAdd(nactive, nact);
}

template <bool INSTANCED>
cudaError_t persistent_blocks(int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
        return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, walk_window_k5_kernel<INSTANCED>, K5_BLOCK, 0))
        != cudaSuccess)
        return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    *blocks = sms * per_sm;
    return cudaSuccess;
}

}  // namespace

// C entry point of K5 (and K6 on it): `state` is a host array of NKEYS
// device pointers in the order of enum Key (null where a field is
// absent: the instance registers of a flat geometry and every on-deck
// field); `rows`, `queue` (one unsigned 32-bit word of scratch, zeroed
// here on `stream` before the launch) and `nactive` (null: no count;
// else one unsigned 64-bit counter the launch adds to) are device
// pointers, `stream` the CUDA stream to launch on; `blocks` the
// persistent grid of mbvh_walk_window_k5_grid on this device.  The
// tree's depth is at most MAX_SLOTS + 1.  Returns the cudaError_t of the
// queue's reset or of the launch.
extern "C" int mbvh_walk_window_k5(const void* rows, void* const* state,
                                   int nkeys, int n, float sq, int depth,
                                   int instanced, int n_iters, int prune,
                                   int blocks, void* queue, void* nactive,
                                   void* stream) {
    if (nkeys != NKEYS) return (int)cudaErrorInvalidValue;
    if (n <= 0 || n_iters <= 0) return (int)cudaSuccess;
    if (depth < 1 || depth - 1 > MAX_SLOTS) return (int)cudaErrorInvalidValue;
    if (blocks < 1 || queue == nullptr) return (int)cudaErrorInvalidValue;
    State st;
    for (int k = 0; k < NKEYS; ++k) st.p[k] = state[k];
    const uint32_t* r = static_cast<const uint32_t*>(rows);
    unsigned* q = static_cast<unsigned*>(queue);
    unsigned long long* na = static_cast<unsigned long long*>(nactive);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // no more warps than lanes
    const long long need = ((long long)n + K5_WARPS - 1) / K5_WARPS;
    const int grid = need < blocks ? (int)need : blocks;
    cudaError_t e = cudaMemsetAsync(q, 0, sizeof(unsigned), s);
    if (e != cudaSuccess) return (int)e;
    if (instanced)
        walk_window_k5_kernel<true><<<grid, K5_BLOCK, 0, s>>>(
            r, st, n, sq, depth, n_iters, prune != 0, q, na);
    else
        walk_window_k5_kernel<false><<<grid, K5_BLOCK, 0, s>>>(
            r, st, n, sq, depth, n_iters, prune != 0, q, na);
    return (int)cudaGetLastError();
}

// The K5 kernel's persistent grid on the current device: *blocks (SMs x
// the blocks an SM holds) of *block_warps warps.  Returns the
// cudaError_t of the query.
extern "C" int mbvh_walk_window_k5_grid(int instanced, int* blocks,
                                        int* block_warps) {
    *block_warps = K5_WARPS;
    return (int)(instanced ? persistent_blocks<true>(blocks)
                           : persistent_blocks<false>(blocks));
}

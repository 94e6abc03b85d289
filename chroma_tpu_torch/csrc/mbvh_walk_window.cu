// On-deck walker window: n_iters MBVH walk iterations per lane, with
// the drain-restart cascade, one thread per lane.
//
// Replaces the on-deck variants of the TPU walker kernel of
// chroma_tpu/ops/mbvh_pallas.py (`_make_kernel(ondeck=True)`, launched
// per iteration by `walk_iter`, :557-654): K3 (od_slots = 1, :405-513)
// and K4 (od_slots = 2, :411-433 and :509-512).  The TPU driver calls
// the kernel once per iteration with the row gather outside it; here
// one launch runs a whole service window of n_iters iterations and each
// thread reads its own rows.  What one iteration computes is exactly
// `walk_iter(ondeck=True)`: the row popped last is processed and the
// next child popped (mbvh_walk_core.cuh), then, in the iteration a
// walk drains,
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
// Lane state lives in device memory across launches, field-major and
// lane-minor: a field of k words per lane is a [k][n] array (tcodes
// [S][64][n], S = depth - 1), so thread i reads and writes word w of a
// field at w * n + i and a warp's accesses are coalesced.  The Python
// wrapper (chroma_tpu_torch/ops/mbvh_walk.py, `walk_window_cuda`)
// passes the fields as an array of device pointers in the order of the
// enum below, which is KERNEL_STATE_KEYS there.
//
// What bounds it on an H100: as the closest-hit kernel, one dependent
// 1,696-byte row read per iteration per thread and the pending codes in
// local memory; in addition, each launch loads and stores the lane
// state (4 B x 64 x S codes dominate).  A lane that has drained with no
// on-deck ray left is a fixed point: its thread stops iterating and
// stores nothing.  Row staging in shared memory, cp.async/TMA and
// warp-level pops are later work.
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

// (field, word) of lane i in a [k][n] array
struct Lanes {
    const State& st;
    size_t n;
    int i;
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

__device__ __forceinline__ void park(const Lanes& L, int base,
                                     const Hit& hit) {
    // base is PARK_DIST or PARK2_DIST; the other fields follow it
    L.f(base) = hit.min_dist;
    for (int k = 0; k < 3; ++k) L.f(base + 1, k) = hit.nrm[k];
    L.s(base + 2) = hit.tri;
    L.s(base + 3) = (int32_t)hit.mat;
}

template <bool INSTANCED, int OD_SLOTS>
__global__ void __launch_bounds__(128)
walk_window_kernel(const uint32_t* __restrict__ rows, State st, int n,
                   float sq, int depth, int n_iters, uint32_t rbase,
                   int rcount, const float* __restrict__ root_lohi) {
    __shared__ float lohi[6 * BRANCH];
    for (int k = threadIdx.x; k < 6 * BRANCH; k += blockDim.x)
        lohi[k] = root_lohi[k];
    __syncthreads();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Lanes L{st, (size_t)n, i};
    const int nslots = depth - 1 > 1 ? depth - 1 : 1;

    // ---- load the lane ----
    Ray ray;
    for (int k = 0; k < 3; ++k) {
        ray.o[k] = L.f(ORG, k);
        ray.d[k] = L.f(DIR, k);
        ray.inv[k] = L.f(INV, k);
        ray.noid[k] = L.f(NOID, k);
    }
    int32_t lht = L.s(LHT);
    Pending pend;
    for (int s = 0; s < nslots; ++s) {
        pend.bases[s] = (uint32_t)L.s(BASES, s);
        for (int j = 0; j < BRANCH; ++j)
            pend.tc[s][j] = (uint16_t)L.s(TCODES, s * BRANCH + j);
    }
    uint32_t ptr = (uint32_t)L.s(PTR);
    bool act = L.b(ACT) != 0;
    int lvl = L.s(LVL);
    Hit hit;
    hit.min_dist = L.f(MIN_DIST);
    for (int k = 0; k < 3; ++k) hit.nrm[k] = L.f(NRM, k);
    hit.tri = L.s(TRI);
    hit.mat = (uint32_t)L.s(MAT);
    Inst inst;
    inst.tbase = L.s(TBASE);
    if (INSTANCED) {
        for (int k = 0; k < 9; ++k) inst.irot[k] = L.f(IROT, k);
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
            for (int k = 0; k < 3; ++k) {
                o[k] = L.f(slot, k);
                d[k] = L.f(slot + 1, k);
            }
            set_ray(ray, o, d);
            lht = L.s(slot + 3);
            clear_hit(hit);
            inst.tbase = 0;
            if (depth >= 2) {
                act = seed_root(nullptr, lohi, rcount, rbase, ray, sq, true,
                                pend.tc[0], &ptr);
                lvl = 1;
            } else {
                // the root is a single cluster row: pop it directly
                for (int j = 0; j < BRANCH; ++j)
                    pend.tc[0][j] = (uint16_t)SENT;
                act = true;
                ptr = 0;
                lvl = 0;
            }
            for (int s = 1; s < nslots; ++s)
                for (int j = 0; j < BRANCH; ++j)
                    pend.tc[s][j] = (uint16_t)SENT;
            pend.bases[0] = rbase;
        }
        pad = ((parked || swap1) ? 1 : 0) | ((done && !swap) ? 2 : 0)
            | ((parked2 || swap2) ? 4 : 0);
    }
    if (!changed) return;

    // ---- store the lane ----
    for (int k = 0; k < 3; ++k) {
        L.f(ORG, k) = ray.o[k];
        L.f(DIR, k) = ray.d[k];
        L.f(INV, k) = ray.inv[k];
        L.f(NOID, k) = ray.noid[k];
    }
    L.s(LHT) = lht;
    for (int s = 0; s < nslots; ++s) {
        L.s(BASES, s) = (int32_t)pend.bases[s];
        for (int j = 0; j < BRANCH; ++j)
            L.s(TCODES, s * BRANCH + j) = (int32_t)pend.tc[s][j];
    }
    L.s(PTR) = (int32_t)ptr;
    L.b(ACT) = act ? 1 : 0;
    L.s(LVL) = lvl;
    L.f(MIN_DIST) = hit.min_dist;
    for (int k = 0; k < 3; ++k) L.f(NRM, k) = hit.nrm[k];
    L.s(TRI) = hit.tri;
    L.s(MAT) = (int32_t)hit.mat;
    L.s(TBASE) = inst.tbase;
    if (INSTANCED) {
        for (int k = 0; k < 9; ++k) L.f(IROT, k) = inst.irot[k];
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
    const int block = 128;
    const int grid = (n + block - 1) / block;
    walk_window_kernel<INSTANCED, OD_SLOTS><<<grid, block, 0, stream>>>(
        rows, st, n, sq, depth, n_iters, rbase, rcount, root_lohi);
}

}  // namespace

// C entry point: `state` is a host array of NKEYS device pointers in
// the order of enum Key (null where a field is absent: the instance
// registers of a flat geometry, the second slot at od_slots = 1);
// `rows` and `root_lohi` are device pointers, `stream` the CUDA stream
// to launch on.  Returns the cudaError_t of the launch.
extern "C" int mbvh_walk_window(const void* rows, void* const* state,
                                int nkeys, int n, float sq, int depth,
                                int instanced, int od_slots, int n_iters,
                                int rbase, int rcount, const void* root_lohi,
                                void* stream) {
    if (nkeys != NKEYS) return (int)cudaErrorInvalidValue;
    if (n <= 0 || n_iters <= 0) return (int)cudaSuccess;
    if (depth < 1 || depth > MAX_SLOTS + 1) return (int)cudaErrorInvalidValue;
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

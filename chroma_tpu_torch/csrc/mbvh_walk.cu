// Closest-hit MBVH walk: one warp per ray, the whole walk in one launch.
//
// Replaces the TPU walker kernel of chroma_tpu/ops/mbvh_pallas.py
// (`_make_kernel`, launched per iteration by `walk_iter`, :557-654)
// together with its host loop `intersect_mesh_pallas` (`seed`, then
// `walk_iter` until no lane is active, then `results`).  K1 (flat) and K2
// (TLAS/BLAS instanced) are the INSTANCED = false and true builds of the
// template below; the iteration itself (row processing, push, prune, pop) is shared with
// the on-deck window kernel in mbvh_walk_core.cuh, which states the
// semantics, the group design and the floating-point rules.
//
// What bounds it on an H100 (counted in chip_smoke.py, op by op from
// the code and from the run's own walks): operations.  A child box costs
// 44 float operations, a triangle 77; 500,000 full-demo center rays make
// 3.2M row visits, 8.8 GFLOP against 52 MB of rays, results and rows
// read, so the bound is 0.13 ms at 67 TFLOP/s fp32.  The kernel runs at
// about 7% of it (PERF.md): the walk is a chain of dependent row reads
// and warp reductions, bound by latency and issue.  What held the
// one-thread-per-ray version back, and what the warp-per-ray design
// does:
//   * a thread read its own 1,696-byte row with scalar loads, so one
//     warp-wide load touched 32 rows: now the warp reads one row, each
//     load instruction 128 contiguous bytes;
//   * the 64-child loops ran serially in each thread and the warp
//     diverged between cluster and internal rows and between walks of
//     different lengths: now each thread tests 2 children and the warp
//     follows one walk;
//   * the 11 x 64 pending codes lived in local memory (1,408 B a thread)
//     and every pop scanned them: now they are MAX_SLOTS = 11 registers a
//     thread and a pop is two warp reductions.
// Builds: <INSTANCED>, one each, holding MAX_SLOTS pending levels, so
// every tree to MAX_LEVELS deep.  Registers: __launch_bounds__(BLOCK,
// MIN_BLOCKS) caps a thread at 64, for 32 rays in flight an SM
// (mbvh_walk_core.cuh).  ptxas (sm_90a, CUDA 12.8; printed by
// chip_smoke.py phase 2), stack frame and spill stores / loads: <false>
// 40 B, 64 B / 52 B; <true> 112 B, 184 B / 160 B.  These are spills of
// the register cap: uncapped, the first warp-per-ray build had no stack
// frame at 90 (flat) and 116 (instanced) registers, so no array is
// indexed at run time, and ran slower (16 rays in flight).
#include "mbvh_walk_core.cuh"

namespace {

using namespace mbvh;

template <bool INSTANCED>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
closest_hit_kernel(const uint32_t* __restrict__ rows,
                   const float* __restrict__ org_in,
                   const float* __restrict__ dir_in,
                   const int32_t* __restrict__ lht_in,
                   const uint8_t* __restrict__ active_in, int n, float sq,
                   int depth, int max_iters, int32_t* __restrict__ tri_out,
                   float* __restrict__ dist_out, float* __restrict__ nrm_out,
                   int32_t* __restrict__ mat_out,
                   uint8_t* __restrict__ inc_out) {
    // one warp per ray: a warp past the ragged edge leaves whole, so the
    // full-mask reductions below always see all 32 threads
    const long long i = group_index();
    if (i >= n) return;

    float o[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        o[k] = org_in[3 * i + k];
        d[k] = dir_in[3 * i + k];
    }
    Ray ray;
    set_ray(ray, o, d);
    const int32_t lht = lht_in[i];
    const int nslots = depth - 1 > 1 ? depth - 1 : 1;

    Pending pend;
    clear_pending(pend);

    // ---- seed: slab-test the root's children and pop the nearest ----
    bool act = active_in[i] != 0;
    int lvl = 0;
    uint32_t ptr = 0;
    if (depth >= 2) {
        act = seed_root(rows, nullptr, (int)(rows[HDR_KIND] >> 8),
                        rows[HDR_BASE], ray, sq, act, pend.tc[0], ptr);
        set_level_base(pend, 0, rows[HDR_BASE]);
        lvl = 1;
    }

    Hit hit;
    clear_hit(hit);
    Inst inst;
    inst.irot = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        inst.iorg[k] = 0.0f;
        inst.idir[k] = 1.0f;
        inst.iinv[k] = 1.0f;
        inst.inoid[k] = 0.0f;
    }
    inst.tbase = 0;

    for (int it = 0; it < max_iters && act; ++it) {
        process_row<INSTANCED>(rows + (size_t)ptr * ROW_WIDTH, ray, lht, sq,
                               depth, lvl, hit, inst, pend);
        act = pop(pend, nslots, hit.min_dist, sq, true, &lvl, &ptr);
    }

    const int t = lane_id();
    if (t < 3) nrm_out[3 * i + t] = hit.nrm;
    if (t == 0) {
        tri_out[i] = hit.tri;
        dist_out[i] = hit.min_dist;
        mat_out[i] = (int32_t)hit.mat;
        inc_out[i] = act ? 1 : 0;
    }
}

template <bool INSTANCED>
void launch(const void* rows, const void* org, const void* dir,
            const void* lht, const void* active, int n, float sq,
            int depth, int max_iters, void* triangle, void* distance,
            void* normal, void* material_code, void* incomplete,
            cudaStream_t stream) {
    const long long threads = (long long)n * G;
    const int grid = (int)((threads + BLOCK - 1) / BLOCK);
    closest_hit_kernel<INSTANCED><<<grid, BLOCK, 0, stream>>>(
        static_cast<const uint32_t*>(rows), static_cast<const float*>(org),
        static_cast<const float*>(dir), static_cast<const int32_t*>(lht),
        static_cast<const uint8_t*>(active), n, sq, depth, max_iters,
        static_cast<int32_t*>(triangle), static_cast<float*>(distance),
        static_cast<float*>(normal), static_cast<int32_t*>(material_code),
        static_cast<uint8_t*>(incomplete));
}

}  // namespace

// C entry point: every pointer is a device pointer, `stream` the CUDA
// stream to launch on; the tree's depth at most MAX_SLOTS + 1.  Returns
// the cudaError_t of the launch.
extern "C" int mbvh_closest_hit(const void* rows, const void* org,
                                const void* dir, const void* lht,
                                const void* active, int n, float sq,
                                int depth, int instanced, int max_iters,
                                void* triangle, void* distance, void* normal,
                                void* material_code, void* incomplete,
                                void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    if (depth < 1 || depth - 1 > MAX_SLOTS) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (instanced)
        launch<true>(rows, org, dir, lht, active, n, sq, depth, max_iters,
                     triangle, distance, normal, material_code, incomplete,
                     s);
    else
        launch<false>(rows, org, dir, lht, active, n, sq, depth, max_iters,
                      triangle, distance, normal, material_code, incomplete,
                      s);
    return (int)cudaGetLastError();
}

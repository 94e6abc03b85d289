// Closest-hit MBVH walk: one thread per ray, the whole walk in one launch.
//
// Replaces the TPU walker kernel of chroma_tpu/ops/mbvh_pallas.py
// (`_make_kernel`, launched per iteration by `walk_iter`) together with
// its host loop `intersect_mesh_pallas` (`seed`, then `walk_iter` until no
// lane is active, then `results`).  K1 (flat) and K2 (TLAS/BLAS
// instanced) are the two instantiations of the template below; the
// iteration itself (row processing, push, prune, pop) is shared with the
// on-deck window kernel in mbvh_walk_core.cuh, which states the
// semantics and the floating-point rules.
//
// What bounds it on an H100: each visited row is a dependent 1,696-byte
// read from device memory (rows are gathered per thread, not per warp),
// and the 11x64 pending codes live in local memory.  This first version
// keeps the structure simple and exact; warp-per-ray rows and
// shared-memory staging are later work.
#include "mbvh_walk_core.cuh"

namespace {

using namespace mbvh;

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

    float o[3], d[3];
    for (int k = 0; k < 3; ++k) {
        o[k] = org_in[3 * i + k];
        d[k] = dir_in[3 * i + k];
    }
    Ray ray;
    set_ray(ray, o, d);
    const int32_t lht = lht_in[i];
    const int nslots = depth - 1 > 1 ? depth - 1 : 1;

    Pending pend;
    for (int s = 0; s < nslots; ++s) {
        pend.bases[s] = 0;
        for (int j = 0; j < BRANCH; ++j) pend.tc[s][j] = (uint16_t)SENT;
    }

    // ---- seed: slab-test the root's children and pop the nearest ----
    bool act = active_in[i] != 0;
    int lvl = 0;
    uint32_t ptr = 0;
    if (depth >= 2) {
        act = seed_root(rows, nullptr, (int)(rows[HDR_KIND] >> 8),
                        rows[HDR_BASE], ray, sq, act, pend.tc[0], &ptr);
        pend.bases[0] = rows[HDR_BASE];
        lvl = 1;
    }

    Hit hit;
    clear_hit(hit);
    Inst inst;
    for (int k = 0; k < 9; ++k) inst.irot[k] = 0.0f;
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
        act = pop(pend, nslots, hit.min_dist, sq, &lvl, &ptr);
    }

    tri_out[i] = hit.tri;
    dist_out[i] = hit.min_dist;
    for (int k = 0; k < 3; ++k) nrm_out[3 * i + k] = hit.nrm[k];
    mat_out[i] = (int32_t)hit.mat;
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

// The window kernels' lane state in device memory, shared by
// mbvh_walk_window.cu (the on-deck windows K3, K4) and
// mbvh_walk_window_k5.cu (the window without on-deck slots, K5).
//
// Every field is field-major and lane-minor ([k][n], word w of lane i at
// w * n + i) but the pending codes `tcodes`, which are lanes-first
// ([n][S][64] int32).  The Python wrapper (chroma_tpu_torch/ops/
// mbvh_walk.py, `walk_window_cuda`) passes the fields as an array of
// device pointers in the order of enum Key, which is KERNEL_STATE_KEYS
// there.
#pragma once

#include <cstddef>
#include <cstdint>

namespace mbvh {

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

}  // namespace mbvh

// Host-side native helpers of chroma_tpu_torch: the functions of the
// JAX package's csrc/chroma_native.cc, copied unchanged so that both
// packages build the same tables and the same CSG solids bit for bit.
//
// Exposed via a plain C ABI and loaded with ctypes
// (chroma_tpu_torch/native.py, which builds it with g++ into
// chroma_tpu_torch/_build/); the numpy implementations remain as a
// fallback so the package works without a compiler.
//
// Functions:
//   quantize_and_morton : per-triangle AABB 16-bit quantization +
//                         48-bit Morton codes (bvh.cu make_leaves)
//   radix_sort_u64      : LSD radix argsort of Morton codes
//   coarsen_group       : one recursive-grid grouping round (grid.py)
//   segment_min_max_u32 : child-AABB unions per parent run
//   sah_wide_build      : binned-SAH wide tree (sah_wide_fetch reads it)
//   csg_boolean         : BSP-tree boolean of two triangle soups
//                         (csg_fetch reads it)

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>
#include <utility>

extern "C" {

// Spread the low 16 bits of x to every third bit slot.
static inline uint64_t spread3_16(uint64_t x) {
    x = (x | (x << 16)) & 0x00000000FF0000FFull;
    x = (x | (x << 8))  & 0x000000F00F00F00Full;
    x = (x | (x << 4))  & 0x00000C30C30C30C3ull;
    x = (x | (x << 2))  & 0x0000249249249249ull;
    return x;
}

// Quantize per-triangle AABBs onto the 16-bit world grid and compute
// centroid Morton codes.  vertices: (nv,3) f32; triangles: (nt,3) i32.
// Outputs: lo/hi (nt,3) u32 (widened by one grid unit like the
// reference), morton (nt) u64.
void quantize_and_morton(const float* vertices, const int32_t* triangles,
                         int64_t ntris, const float* world_origin,
                         float world_scale, uint32_t* lo, uint32_t* hi,
                         uint64_t* morton) {
    const float inv_scale = 1.0f / world_scale;
    for (int64_t t = 0; t < ntris; ++t) {
        float mn[3], mx[3], cen[3];
        for (int k = 0; k < 3; ++k) {
            mn[k] = 3.4e38f; mx[k] = -3.4e38f; cen[k] = 0.0f;
        }
        for (int j = 0; j < 3; ++j) {
            const float* v = vertices + 3 * (int64_t)triangles[3 * t + j];
            for (int k = 0; k < 3; ++k) {
                float x = v[k];
                if (x < mn[k]) mn[k] = x;
                if (x > mx[k]) mx[k] = x;
                cen[k] += x;
            }
        }
        uint64_t code = 0;
        for (int k = 0; k < 3; ++k) {
            // truncating quantization, matching the reference builder
            uint32_t ql = (uint32_t)((mn[k] - world_origin[k]) * inv_scale);
            uint32_t qh = (uint32_t)((mx[k] - world_origin[k]) * inv_scale);
            uint32_t qc = (uint32_t)((cen[k] / 3.0f - world_origin[k])
                                     * inv_scale);
            lo[3 * t + k] = ql > 0 ? ql - 1 : 0;
            hi[3 * t + k] = qh + 1;
            code |= spread3_16(qc) << k;
        }
        morton[t] = code;
    }
}

// Stable LSD radix argsort of u64 keys; writes the permutation into
// order (caller allocates n int64).
void radix_sort_u64(const uint64_t* keys, int64_t n, int64_t* order) {
    std::vector<int64_t> a(n), b(n);
    for (int64_t i = 0; i < n; ++i) a[i] = i;
    std::vector<int64_t> count(1 << 16);
    for (int pass = 0; pass < 4; ++pass) {
        const int shift = pass * 16;
        std::fill(count.begin(), count.end(), 0);
        for (int64_t i = 0; i < n; ++i)
            ++count[(keys[a[i]] >> shift) & 0xFFFF];
        int64_t total = 0;
        for (size_t c = 0; c < count.size(); ++c) {
            int64_t tmp = count[c];
            count[c] = total;
            total += tmp;
        }
        for (int64_t i = 0; i < n; ++i)
            b[count[(keys[a[i]] >> shift) & 0xFFFF]++] = a[i];
        a.swap(b);
    }
    std::memcpy(order, a.data(), n * sizeof(int64_t));
}

// One recursive-grid grouping round: coarsen sorted Morton codes until
// the mean fan-out reaches target_degree, then emit run starts split
// at max_child.  Returns the number of parents; first_child must have
// room for n entries.  codes is modified in place (coarsened).
int64_t coarsen_group(uint64_t* codes, int64_t n, double target_degree,
                      int64_t max_child, int64_t* first_child) {
    if (n <= 0) return 0;
    // count unique runs
    auto count_unique = [&]() {
        int64_t u = 1;
        for (int64_t i = 1; i < n; ++i) u += (codes[i] != codes[i - 1]);
        return u;
    };
    int64_t nunique = count_unique();
    while ((double)n / (double)(nunique > 0 ? nunique : 1) < target_degree
           && nunique > 1) {
        for (int64_t i = 0; i < n; ++i) codes[i] >>= 1;
        nunique = count_unique();
    }
    int64_t nparent = 0;
    int64_t run_start = 0;
    for (int64_t i = 1; i <= n; ++i) {
        if (i == n || codes[i] != codes[i - 1]) {
            for (int64_t s = run_start; s < i; s += max_child)
                first_child[nparent++] = s;
            run_start = i;
        }
    }
    return nparent;
}

// Per-parent AABB unions: for each parent p covering children
// [first_child[p], first_child[p]+nchild[p]), min/max-reduce the
// (n,3) u32 lo/hi arrays into (np,3) outputs.
void segment_min_max_u32(const uint32_t* lo, const uint32_t* hi,
                         const int64_t* first_child, const int64_t* nchild,
                         int64_t nparent, uint32_t* out_lo,
                         uint32_t* out_hi) {
    for (int64_t p = 0; p < nparent; ++p) {
        const int64_t s = first_child[p];
        const int64_t e = s + nchild[p];
        uint32_t mn[3] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
        uint32_t mx[3] = {0, 0, 0};
        for (int64_t i = s; i < e; ++i) {
            for (int k = 0; k < 3; ++k) {
                uint32_t l = lo[3 * i + k], h = hi[3 * i + k];
                if (l < mn[k]) mn[k] = l;
                if (h > mx[k]) mx[k] = h;
            }
        }
        for (int k = 0; k < 3; ++k) {
            out_lo[3 * p + k] = mn[k];
            out_hi[3 * p + k] = mx[k];
        }
    }
}


// ---------------------------------------------------------------------
// Binned-SAH wide-BVH builder (host-side replacement for the Morton
// recursive-grid grouping; the reference's SAH gesture is the
// per-layer area optimizer at chroma/gpu/bvh.py:269).  A binary
// binned-SAH tree is built top-down, cut into <=leaf_max-primitive
// "atoms", and collapsed into BRANCH-wide nodes by repeatedly
// expanding the largest-surface-area frontier member.  Wide node ids
// are assigned in BFS order so every node's children occupy
// consecutive ids (the only ordering the walker requires).

namespace sah {

struct BNode {
    float lo[3], hi[3];
    int64_t start, count;     // prim-order range
    int64_t left = -1, right = -1;
};

struct Built {
    std::vector<uint8_t> kind;         // 1 = cluster (atom)
    std::vector<int64_t> child_start;  // internal: first child wide id;
    std::vector<int64_t> child_count;  //   cluster: offset into leaf_order
    std::vector<int64_t> leaf_order;
    std::vector<float> node_lo, node_hi;
    int64_t depth = 0;
};

static Built g_built;

static inline float area(const float* lo, const float* hi) {
    float dx = hi[0] - lo[0], dy = hi[1] - lo[1], dz = hi[2] - lo[2];
    return dx * dy + dy * dz + dz * dx;
}

}  // namespace sah

// Build the wide tree over n leaf AABBs.  branch = max children per
// wide node, leaf_max = max leaves per cluster (1 for TLAS candidate
// trees, BRANCH for triangle clusters).  Returns the wide node count
// (root = id 0); out_depth[0] = tree depth in levels.  Fetch arrays
// with sah_wide_fetch (kind/child_start/child_count sized W,
// leaf_order sized n, node_lo/node_hi sized 3*W).
int64_t sah_wide_build(const float* leaf_lo, const float* leaf_hi,
                       int64_t n, int64_t branch, int64_t leaf_max,
                       int64_t* out_depth) {
    using namespace sah;
    g_built = Built();
    if (n <= 0) { if (out_depth) *out_depth = 0; return 0; }

    // centroids + prim order
    std::vector<float> cen(3 * n);
    for (int64_t i = 0; i < n; ++i)
        for (int k = 0; k < 3; ++k)
            cen[3 * i + k] = 0.5f * (leaf_lo[3 * i + k]
                                     + leaf_hi[3 * i + k]);
    std::vector<int64_t> prim(n);
    for (int64_t i = 0; i < n; ++i) prim[i] = i;

    // ---- binary binned SAH, explicit stack --------------------------
    std::vector<BNode> bn;
    bn.reserve((size_t)(n > 4 ? 2 * n : 8));
    const int NBINS = 16;
    const int64_t stop_count = leaf_max > 16 ? leaf_max / 16 : 1;

    auto make_node = [&](int64_t start, int64_t count) -> int64_t {
        BNode nd;
        nd.start = start; nd.count = count;
        for (int k = 0; k < 3; ++k) { nd.lo[k] = 3.4e38f; nd.hi[k] = -3.4e38f; }
        for (int64_t i = start; i < start + count; ++i) {
            const int64_t p = prim[i];
            for (int k = 0; k < 3; ++k) {
                if (leaf_lo[3 * p + k] < nd.lo[k]) nd.lo[k] = leaf_lo[3 * p + k];
                if (leaf_hi[3 * p + k] > nd.hi[k]) nd.hi[k] = leaf_hi[3 * p + k];
            }
        }
        bn.push_back(nd);
        return (int64_t)bn.size() - 1;
    };

    const int64_t root = make_node(0, n);
    std::vector<int64_t> stack{root};
    while (!stack.empty()) {
        const int64_t ni = stack.back(); stack.pop_back();
        const int64_t start = bn[ni].start, count = bn[ni].count;
        if (count <= stop_count) continue;           // binary leaf

        // centroid bounds over the range
        float clo[3] = {3.4e38f, 3.4e38f, 3.4e38f};
        float chi[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
        for (int64_t i = start; i < start + count; ++i) {
            const float* c = &cen[3 * prim[i]];
            for (int k = 0; k < 3; ++k) {
                if (c[k] < clo[k]) clo[k] = c[k];
                if (c[k] > chi[k]) chi[k] = c[k];
            }
        }
        int axis = 0;
        float ext = chi[0] - clo[0];
        for (int k = 1; k < 3; ++k)
            if (chi[k] - clo[k] > ext) { ext = chi[k] - clo[k]; axis = k; }

        int64_t mid;
        if (ext <= 0.0f) {
            mid = start + count / 2;                 // degenerate: median
        } else {
            // bin prims by centroid
            float blo[NBINS][3], bhi[NBINS][3];
            int64_t bcnt[NBINS];
            for (int b = 0; b < NBINS; ++b) {
                bcnt[b] = 0;
                for (int k = 0; k < 3; ++k) { blo[b][k] = 3.4e38f; bhi[b][k] = -3.4e38f; }
            }
            const float scale = NBINS / ext;
            for (int64_t i = start; i < start + count; ++i) {
                const int64_t p = prim[i];
                int b = (int)((cen[3 * p + axis] - clo[axis]) * scale);
                if (b < 0) b = 0;
                if (b >= NBINS) b = NBINS - 1;
                ++bcnt[b];
                for (int k = 0; k < 3; ++k) {
                    if (leaf_lo[3 * p + k] < blo[b][k]) blo[b][k] = leaf_lo[3 * p + k];
                    if (leaf_hi[3 * p + k] > bhi[b][k]) bhi[b][k] = leaf_hi[3 * p + k];
                }
            }
            // sweep: best of NBINS-1 split planes by SAH
            float rlo[NBINS][3], rhi[NBINS][3];
            float racc[3] = {3.4e38f, 3.4e38f, 3.4e38f};
            float racc2[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
            int64_t rcnt[NBINS];
            int64_t rc = 0;
            for (int b = NBINS - 1; b >= 1; --b) {
                for (int k = 0; k < 3; ++k) {
                    if (blo[b][k] < racc[k]) racc[k] = blo[b][k];
                    if (bhi[b][k] > racc2[k]) racc2[k] = bhi[b][k];
                    rlo[b][k] = racc[k]; rhi[b][k] = racc2[k];
                }
                rc += bcnt[b];
                rcnt[b] = rc;
            }
            float llo[3] = {3.4e38f, 3.4e38f, 3.4e38f};
            float lhi[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
            int64_t lc = 0;
            float best = 3.4e38f;
            int bestb = -1;
            for (int b = 0; b < NBINS - 1; ++b) {
                lc += bcnt[b];
                for (int k = 0; k < 3; ++k) {
                    if (blo[b][k] < llo[k]) llo[k] = blo[b][k];
                    if (bhi[b][k] > lhi[k]) lhi[k] = bhi[b][k];
                }
                if (lc == 0 || rcnt[b + 1] == 0) continue;
                const float cost = area(llo, lhi) * (float)lc
                    + area(rlo[b + 1], rhi[b + 1]) * (float)rcnt[b + 1];
                if (cost < best) { best = cost; bestb = b; }
            }
            if (bestb < 0) {
                mid = start + count / 2;
            } else {
                // partition by bin
                const float split = clo[axis] + (bestb + 1) * ext / NBINS;
                int64_t i = start, j = start + count - 1;
                while (i <= j) {
                    if (cen[3 * prim[i] + axis] < split) { ++i; }
                    else { std::swap(prim[i], prim[j]); --j; }
                }
                mid = i;
                if (mid == start || mid == start + count)
                    mid = start + count / 2;         // numeric edge: median
            }
        }
        const int64_t li = make_node(start, mid - start);
        const int64_t ri = make_node(mid, start + count - mid);
        bn[ni].left = li;
        bn[ni].right = ri;
        stack.push_back(li);
        stack.push_back(ri);
    }

    // ---- collapse to wide nodes, BFS (children consecutive) ---------
    Built& out = g_built;
    out.leaf_order.reserve(n);
    std::vector<int64_t> queue{root};       // binary node per wide id
    std::vector<int64_t> level{1};
    int64_t head = 0;
    while (head < (int64_t)queue.size()) {
        const int64_t b = queue[head];
        const int64_t lev = level[head];
        ++head;
        if (lev > out.depth) out.depth = lev;
        for (int k = 0; k < 3; ++k) {
            out.node_lo.push_back(bn[b].lo[k]);
            out.node_hi.push_back(bn[b].hi[k]);
        }
        if (bn[b].count <= leaf_max) {               // atom -> cluster
            out.kind.push_back(1);
            out.child_start.push_back((int64_t)out.leaf_order.size());
            out.child_count.push_back(bn[b].count);
            for (int64_t i = bn[b].start; i < bn[b].start + bn[b].count; ++i)
                out.leaf_order.push_back(prim[i]);
            continue;
        }
        // frontier expansion: largest-area internal member first
        std::vector<int64_t> frontier{bn[b].left, bn[b].right};
        for (;;) {
            if ((int64_t)frontier.size() >= branch) break;
            int64_t pick = -1;
            float best_a = -1.0f;
            for (size_t f = 0; f < frontier.size(); ++f) {
                const BNode& fn = bn[frontier[f]];
                if (fn.count <= leaf_max || fn.left < 0) continue;
                const float a = area(fn.lo, fn.hi);
                if (a > best_a) { best_a = a; pick = (int64_t)f; }
            }
            if (pick < 0) break;
            const int64_t l = bn[frontier[pick]].left;
            const int64_t r = bn[frontier[pick]].right;
            frontier[pick] = l;
            frontier.push_back(r);
        }
        // deterministic child order: by prim range start
        std::sort(frontier.begin(), frontier.end(),
                  [&](int64_t a, int64_t c) {
                      return bn[a].start < bn[c].start;
                  });
        out.kind.push_back(0);
        out.child_start.push_back((int64_t)queue.size());
        out.child_count.push_back((int64_t)frontier.size());
        for (int64_t f : frontier) {
            queue.push_back(f);
            level.push_back(lev + 1);
        }
    }
    if (out_depth) *out_depth = out.depth;
    return (int64_t)out.kind.size();
}

void sah_wide_fetch(uint8_t* kind, int64_t* child_start,
                    int64_t* child_count, int64_t* leaf_order,
                    float* node_lo, float* node_hi) {
    using namespace sah;
    std::memcpy(kind, g_built.kind.data(), g_built.kind.size());
    std::memcpy(child_start, g_built.child_start.data(),
                g_built.child_start.size() * sizeof(int64_t));
    std::memcpy(child_count, g_built.child_count.data(),
                g_built.child_count.size() * sizeof(int64_t));
    std::memcpy(leaf_order, g_built.leaf_order.data(),
                g_built.leaf_order.size() * sizeof(int64_t));
    std::memcpy(node_lo, g_built.node_lo.data(),
                g_built.node_lo.size() * sizeof(float));
    std::memcpy(node_hi, g_built.node_hi.data(),
                g_built.node_hi.size() * sizeof(float));
    g_built = Built();
}

// ---------------------------------------------------------------------
// BSP-tree CSG on triangle soups (native backend of chroma_tpu_torch/csg.py;
// the reference meshes boolean solids through gmsh/OCC,
// chroma/rat/gen_mesh.py:56).  Thibault-Naylor polygon clipping.

namespace csg {

struct V3 { double x, y, z; };
static inline V3 sub3(V3 a, V3 b) { return {a.x-b.x, a.y-b.y, a.z-b.z}; }
static inline V3 add3(V3 a, V3 b) { return {a.x+b.x, a.y+b.y, a.z+b.z}; }
static inline V3 mul3(V3 a, double s) { return {a.x*s, a.y*s, a.z*s}; }
static inline double dot3(V3 a, V3 b) { return a.x*b.x + a.y*b.y + a.z*b.z; }
static inline V3 cross3(V3 a, V3 b) {
    return {a.y*b.z - a.z*b.y, a.z*b.x - a.x*b.z, a.x*b.y - a.y*b.x};
}

struct Poly {
    std::vector<V3> v;
    V3 n;
    double w;
    void flip() {
        std::reverse(v.begin(), v.end());
        n = mul3(n, -1.0); w = -w;
    }
};

static const double kEps = 1e-6;

static void split_poly(const V3& n, double w, const Poly& p,
                       std::vector<Poly>& cofront, std::vector<Poly>& coback,
                       std::vector<Poly>& front, std::vector<Poly>& back) {
    enum { COP = 0, FRONT = 1, BACK = 2, SPAN = 3 };
    int ptype = 0;
    std::vector<int> types(p.v.size());
    for (size_t i = 0; i < p.v.size(); ++i) {
        double t = dot3(n, p.v[i]) - w;
        int typ = (t < -kEps) ? BACK : (t > kEps ? FRONT : COP);
        ptype |= typ;
        types[i] = typ;
    }
    switch (ptype) {
    case COP:
        (dot3(n, p.n) > 0 ? cofront : coback).push_back(p);
        break;
    case FRONT: front.push_back(p); break;
    case BACK:  back.push_back(p);  break;
    default: {
        Poly f, b;
        f.n = p.n; f.w = p.w; b.n = p.n; b.w = p.w;
        size_t cnt = p.v.size();
        for (size_t i = 0; i < cnt; ++i) {
            size_t j = (i + 1) % cnt;
            int ti = types[i], tj = types[j];
            V3 vi = p.v[i], vj = p.v[j];
            if (ti != BACK)  f.v.push_back(vi);
            if (ti != FRONT) b.v.push_back(vi);
            if ((ti | tj) == SPAN) {
                double t = (w - dot3(n, vi)) / dot3(n, sub3(vj, vi));
                V3 vv = add3(vi, mul3(sub3(vj, vi), t));
                f.v.push_back(vv);
                b.v.push_back(vv);
            }
        }
        if (f.v.size() >= 3) front.push_back(std::move(f));
        if (b.v.size() >= 3) back.push_back(std::move(b));
    }
    }
}

struct Node {
    bool has_plane = false;
    V3 n{0, 0, 0};
    double w = 0;
    int front = -1, back = -1;
    std::vector<Poly> polys;
};

struct Tree {
    std::vector<Node> nodes;
    int make() { nodes.emplace_back(); return (int)nodes.size() - 1; }

    void build(int root, std::vector<Poly> polys) {
        std::vector<std::pair<int, std::vector<Poly>>> stack;
        stack.emplace_back(root, std::move(polys));
        while (!stack.empty()) {
            auto item = std::move(stack.back());
            stack.pop_back();
            int ni = item.first;
            auto& ps = item.second;
            if (ps.empty()) continue;
            if (!nodes[ni].has_plane) {
                nodes[ni].has_plane = true;
                nodes[ni].n = ps[0].n;
                nodes[ni].w = ps[0].w;
            }
            std::vector<Poly> front, back;
            for (auto& p : ps)
                split_poly(nodes[ni].n, nodes[ni].w, p,
                           nodes[ni].polys, nodes[ni].polys, front, back);
            if (!front.empty()) {
                if (nodes[ni].front < 0) {
                    int c = make();
                    nodes[ni].front = c;
                }
                stack.emplace_back(nodes[ni].front, std::move(front));
            }
            if (!back.empty()) {
                if (nodes[ni].back < 0) {
                    int c = make();
                    nodes[ni].back = c;
                }
                stack.emplace_back(nodes[ni].back, std::move(back));
            }
        }
    }

    void invert(int root) {
        std::vector<int> stack{root};
        while (!stack.empty()) {
            int ni = stack.back(); stack.pop_back();
            Node& nd = nodes[ni];
            for (auto& p : nd.polys) p.flip();
            if (nd.has_plane) { nd.n = mul3(nd.n, -1.0); nd.w = -nd.w; }
            std::swap(nd.front, nd.back);
            if (nd.front >= 0) stack.push_back(nd.front);
            if (nd.back >= 0) stack.push_back(nd.back);
        }
    }

    std::vector<Poly> clip_polys(int root, std::vector<Poly> polys) const {
        std::vector<Poly> out;
        std::vector<std::pair<int, std::vector<Poly>>> stack;
        stack.emplace_back(root, std::move(polys));
        while (!stack.empty()) {
            auto item = std::move(stack.back());
            stack.pop_back();
            const Node& nd = nodes[item.first];
            if (!nd.has_plane) {
                for (auto& p : item.second) out.push_back(std::move(p));
                continue;
            }
            std::vector<Poly> front, back;
            for (auto& p : item.second)
                split_poly(nd.n, nd.w, p, front, back, front, back);
            if (nd.front >= 0)
                stack.emplace_back(nd.front, std::move(front));
            else
                for (auto& p : front) out.push_back(std::move(p));
            if (nd.back >= 0)
                stack.emplace_back(nd.back, std::move(back));
            // polygons behind a leaf plane are inside the solid: dropped
        }
        return out;
    }

    void clip_to(int root, const Tree& other, int other_root) {
        std::vector<int> stack{root};
        while (!stack.empty()) {
            int ni = stack.back(); stack.pop_back();
            nodes[ni].polys =
                other.clip_polys(other_root, std::move(nodes[ni].polys));
            if (nodes[ni].front >= 0) stack.push_back(nodes[ni].front);
            if (nodes[ni].back >= 0) stack.push_back(nodes[ni].back);
        }
    }

    void all_polys(int root, std::vector<Poly>& out) const {
        std::vector<int> stack{root};
        while (!stack.empty()) {
            int ni = stack.back(); stack.pop_back();
            for (const auto& p : nodes[ni].polys) out.push_back(p);
            if (nodes[ni].front >= 0) stack.push_back(nodes[ni].front);
            if (nodes[ni].back >= 0) stack.push_back(nodes[ni].back);
        }
    }
};

static std::vector<Poly> soup_to_polys(const double* tris, int64_t n) {
    std::vector<Poly> out;
    out.reserve(n);
    for (int64_t i = 0; i < n; ++i) {
        const double* t = tris + 9 * i;
        Poly p;
        p.v = {{t[0], t[1], t[2]}, {t[3], t[4], t[5]}, {t[6], t[7], t[8]}};
        V3 nv = cross3(sub3(p.v[1], p.v[0]), sub3(p.v[2], p.v[0]));
        double ln = std::sqrt(dot3(nv, nv));
        if (ln < 1e-30) continue;
        p.n = mul3(nv, 1.0 / ln);
        p.w = dot3(p.n, p.v[0]);
        out.push_back(std::move(p));
    }
    return out;
}

static std::vector<double> g_csg_result;

}  // namespace csg

// op: 0=union, 1=subtraction, 2=intersection.  Returns the output
// triangle count; fetch with csg_fetch (fan-triangulated).
int64_t csg_boolean(int op, const double* tris_a, int64_t na,
                    const double* tris_b, int64_t nb) {
    using namespace csg;
    Tree ta, tb;
    int ra = ta.make(), rb = tb.make();
    ta.build(ra, soup_to_polys(tris_a, na));
    tb.build(rb, soup_to_polys(tris_b, nb));

    bool flip_b = false;
    if (op == 0) {                       // union
        ta.clip_to(ra, tb, rb);
        tb.clip_to(rb, ta, ra);
        tb.invert(rb);
        tb.clip_to(rb, ta, ra);
        tb.invert(rb);
    } else if (op == 1) {                // subtraction
        ta.invert(ra);
        ta.clip_to(ra, tb, rb);
        tb.clip_to(rb, ta, ra);
        tb.invert(rb);
        tb.clip_to(rb, ta, ra);
        tb.invert(rb);
        ta.invert(ra);
        flip_b = true;                   // B's piece bounds a cavity
    } else {                             // intersection
        ta.invert(ra);
        tb.clip_to(rb, ta, ra);
        tb.invert(rb);
        ta.clip_to(ra, tb, rb);
        tb.clip_to(rb, ta, ra);
        ta.invert(ra);
        tb.invert(rb);
    }
    std::vector<Poly> polys;
    ta.all_polys(ra, polys);
    size_t nb_start = polys.size();
    tb.all_polys(rb, polys);
    if (flip_b)
        for (size_t i = nb_start; i < polys.size(); ++i) polys[i].flip();

    g_csg_result.clear();
    int64_t ntri = 0;
    for (const auto& p : polys) {
        for (size_t i = 1; i + 1 < p.v.size(); ++i) {
            const V3 tri[3] = {p.v[0], p.v[i], p.v[i + 1]};
            for (int k = 0; k < 3; ++k) {
                g_csg_result.push_back(tri[k].x);
                g_csg_result.push_back(tri[k].y);
                g_csg_result.push_back(tri[k].z);
            }
            ++ntri;
        }
    }
    return ntri;
}

void csg_fetch(double* out) {
    std::memcpy(out, csg::g_csg_result.data(),
                csg::g_csg_result.size() * sizeof(double));
    csg::g_csg_result.clear();
    csg::g_csg_result.shrink_to_fit();
}

}  // extern "C"

// rtvs_native: native runtime components for raytracevs_tpu.
//
// Host-side counterpart of the reference's C++ engine-side work
// (src/RayTraceVS.DXEngine): where the reference builds acceleration
// structures through the D3D12 driver (AccelerationStructure.cpp:560-663),
// this library builds the triangle BVH on the host with a binned-SAH
// sweep and emits the same flat threaded (skip-link) arrays the device
// traversal consumes (ops/bvh.py). Also provides the FNV-1a checksum used
// for scene-change detection (DXRPipeline.cpp:2795-2859 analog) and a
// binary .mesh codec check.
//
// Exposed via a plain C ABI (NativeBridge.h analog) and loaded from Python
// with ctypes; a pure-numpy fallback exists when the library is absent.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
    Vec3 lo{1e30f, 1e30f, 1e30f};
    Vec3 hi{-1e30f, -1e30f, -1e30f};
    void grow(const AABB& o) {
        lo = vmin(lo, o.lo);
        hi = vmax(hi, o.hi);
    }
    void grow(const Vec3& p) {
        lo = vmin(lo, p);
        hi = vmax(hi, p);
    }
    float area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return 2.f * (dx * dy + dy * dz + dz * dx);
    }
    Vec3 centroid() const {
        return {(lo.x + hi.x) * 0.5f, (lo.y + hi.y) * 0.5f, (lo.z + hi.z) * 0.5f};
    }
};

struct BuildNode {
    AABB bounds;
    int left = -1;   // child node index (internal) or -1
    int right = -1;
    int start = 0;   // leaf triangle range in `order`
    int count = 0;
};

struct Builder {
    const AABB* tri_bounds;
    std::vector<int> order;
    std::vector<BuildNode> nodes;
    int leaf_size;

    static constexpr int kBins = 16;

    int build(int begin, int end) {
        int me = (int)nodes.size();
        nodes.emplace_back();
        AABB bounds, cbounds;
        for (int i = begin; i < end; ++i) {
            bounds.grow(tri_bounds[order[i]]);
            cbounds.grow(tri_bounds[order[i]].centroid());
        }
        nodes[me].bounds = bounds;
        int n = end - begin;
        if (n <= leaf_size) {
            nodes[me].start = begin;
            nodes[me].count = n;
            return me;
        }

        // Binned SAH over the widest centroid axis.
        Vec3 ext = {cbounds.hi.x - cbounds.lo.x, cbounds.hi.y - cbounds.lo.y,
                    cbounds.hi.z - cbounds.lo.z};
        int axis = 0;
        float w = ext.x;
        if (ext.y > w) { axis = 1; w = ext.y; }
        if (ext.z > w) { axis = 2; w = ext.z; }
        float lo = axis == 0 ? cbounds.lo.x : (axis == 1 ? cbounds.lo.y : cbounds.lo.z);
        if (w < 1e-12f) {
            // Degenerate spread: median split.
            int mid = begin + n / 2;
            int l = build(begin, mid);
            int r = build(mid, end);
            nodes[me].left = l;
            nodes[me].right = r;
            return me;
        }

        AABB bin_bounds[kBins];
        int bin_count[kBins] = {0};
        float inv = kBins / w;
        auto bin_of = [&](int tri) {
            Vec3 c = tri_bounds[tri].centroid();
            float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
            int b = (int)((v - lo) * inv);
            return std::min(std::max(b, 0), kBins - 1);
        };
        for (int i = begin; i < end; ++i) {
            int b = bin_of(order[i]);
            bin_bounds[b].grow(tri_bounds[order[i]]);
            bin_count[b]++;
        }

        // Sweep for the best split plane.
        AABB right_acc[kBins];
        AABB acc;
        for (int b = kBins - 1; b >= 1; --b) {
            acc.grow(bin_bounds[b]);
            right_acc[b] = acc;
        }
        float best_cost = 1e30f;
        int best_split = -1;
        AABB lacc;
        int lcount = 0;
        for (int b = 0; b < kBins - 1; ++b) {
            lacc.grow(bin_bounds[b]);
            lcount += bin_count[b];
            int rcount = n - lcount;
            if (lcount == 0 || rcount == 0) continue;
            float cost = lacc.area() * lcount + right_acc[b + 1].area() * rcount;
            if (cost < best_cost) {
                best_cost = cost;
                best_split = b;
            }
        }

        int mid;
        if (best_split < 0 || best_cost >= bounds.area() * n) {
            mid = begin + n / 2;
            std::nth_element(
                order.begin() + begin, order.begin() + mid, order.begin() + end,
                [&](int a, int b2) {
                    Vec3 ca = tri_bounds[a].centroid();
                    Vec3 cb = tri_bounds[b2].centroid();
                    float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                    float vb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
                    return va < vb;
                });
        } else {
            auto it = std::partition(order.begin() + begin, order.begin() + end,
                                     [&](int t) { return bin_of(t) <= best_split; });
            mid = (int)(it - order.begin());
            if (mid == begin || mid == end) mid = begin + n / 2;
        }

        int l = build(begin, mid);
        int r = build(mid, end);
        nodes[me].left = l;
        nodes[me].right = r;
        return me;
    }
};

// Iterative threading (skip links) to avoid deep recursion on host stacks.
void thread_bvh(const std::vector<BuildNode>& nodes, int root, int* hit_next,
                int* miss_next, int* tri_start, int* tri_count, float* bbox_min,
                float* bbox_max) {
    std::vector<std::pair<int, int>> stack;  // (node, miss)
    stack.emplace_back(root, -1);
    while (!stack.empty()) {
        auto [node, miss] = stack.back();
        stack.pop_back();
        const BuildNode& bn = nodes[node];
        bbox_min[node * 3 + 0] = bn.bounds.lo.x;
        bbox_min[node * 3 + 1] = bn.bounds.lo.y;
        bbox_min[node * 3 + 2] = bn.bounds.lo.z;
        bbox_max[node * 3 + 0] = bn.bounds.hi.x;
        bbox_max[node * 3 + 1] = bn.bounds.hi.y;
        bbox_max[node * 3 + 2] = bn.bounds.hi.z;
        miss_next[node] = miss;
        if (bn.left < 0) {
            tri_start[node] = bn.start;
            tri_count[node] = bn.count;
            hit_next[node] = miss;
        } else {
            tri_start[node] = 0;
            tri_count[node] = 0;
            hit_next[node] = bn.left;
            // push right first so left is processed next (preorder)
            stack.emplace_back(bn.right, miss);
            stack.emplace_back(bn.left, bn.right);
        }
    }
}

}  // namespace

extern "C" {

// Build a threaded BVH. Outputs are caller-allocated with capacity
// 2*num_tris nodes. Returns the node count (or -1 on error).
int rtvs_build_bvh(const float* v0, const float* v1, const float* v2,
                   int num_tris, int leaf_size, float* bbox_min, float* bbox_max,
                   int* hit_next, int* miss_next, int* tri_start, int* tri_count,
                   int* tri_order) {
    if (num_tris <= 0 || leaf_size <= 0) return -1;
    std::vector<AABB> tb((size_t)num_tris);
    for (int i = 0; i < num_tris; ++i) {
        Vec3 a{v0[i * 3], v0[i * 3 + 1], v0[i * 3 + 2]};
        Vec3 b{v1[i * 3], v1[i * 3 + 1], v1[i * 3 + 2]};
        Vec3 c{v2[i * 3], v2[i * 3 + 1], v2[i * 3 + 2]};
        tb[i].grow(a);
        tb[i].grow(b);
        tb[i].grow(c);
    }
    Builder builder;
    builder.tri_bounds = tb.data();
    builder.leaf_size = leaf_size;
    builder.order.resize((size_t)num_tris);
    for (int i = 0; i < num_tris; ++i) builder.order[i] = i;
    builder.nodes.reserve((size_t)num_tris * 2);
    int root = builder.build(0, num_tris);
    // The recursive build emits preorder already (node appended before
    // children), so `root` is 0 and indices are final.
    (void)root;
    thread_bvh(builder.nodes, 0, hit_next, miss_next, tri_start, tri_count,
               bbox_min, bbox_max);
    std::memcpy(tri_order, builder.order.data(), sizeof(int) * (size_t)num_tris);
    return (int)builder.nodes.size();
}

// Build a threaded BVH over EXPLICIT reference bounds (pre-split
// references: several tight boxes may point at the same triangle, the
// SBVH-style answer to sliver triangles — the driver BLAS the reference
// relies on does equivalent splitting internally). Outputs are
// caller-allocated with capacity 2*num_refs nodes; `ref_order` maps leaf
// slots back to reference indices. Returns the node count (or -1).
int rtvs_build_bvh_refs(const float* ref_min, const float* ref_max,
                        int num_refs, int leaf_size, float* bbox_min,
                        float* bbox_max, int* hit_next, int* miss_next,
                        int* tri_start, int* tri_count, int* ref_order) {
    if (num_refs <= 0 || leaf_size <= 0) return -1;
    std::vector<AABB> tb((size_t)num_refs);
    for (int i = 0; i < num_refs; ++i) {
        tb[i].lo = {ref_min[i * 3], ref_min[i * 3 + 1], ref_min[i * 3 + 2]};
        tb[i].hi = {ref_max[i * 3], ref_max[i * 3 + 1], ref_max[i * 3 + 2]};
    }
    Builder builder;
    builder.tri_bounds = tb.data();
    builder.leaf_size = leaf_size;
    builder.order.resize((size_t)num_refs);
    for (int i = 0; i < num_refs; ++i) builder.order[i] = i;
    builder.nodes.reserve((size_t)num_refs * 2);
    builder.build(0, num_refs);
    thread_bvh(builder.nodes, 0, hit_next, miss_next, tri_start, tri_count,
               bbox_min, bbox_max);
    std::memcpy(ref_order, builder.order.data(), sizeof(int) * (size_t)num_refs);
    return (int)builder.nodes.size();
}

// Pre-split sliver triangles into multiple tight reference boxes
// (Ernst & Greiner "early split clipping"). Splits the largest-area
// references at their box's longest-axis midpoint, clipping the triangle
// polygon to each half, until the reference budget is reached. Outputs
// (ref_tri, ref_min, ref_max) arrays of capacity max_refs; returns the
// reference count.
int rtvs_presplit(const float* v0, const float* v1, const float* v2,
                  int num_tris, int max_refs, int* ref_tri, float* ref_min,
                  float* ref_max) {
    if (num_tris <= 0 || max_refs < num_tris) return -1;
    struct Ref {
        AABB box;
        int tri;
    };
    std::vector<Ref> refs;
    refs.reserve((size_t)max_refs);
    for (int i = 0; i < num_tris; ++i) {
        AABB b;
        b.grow(Vec3{v0[i * 3], v0[i * 3 + 1], v0[i * 3 + 2]});
        b.grow(Vec3{v1[i * 3], v1[i * 3 + 1], v1[i * 3 + 2]});
        b.grow(Vec3{v2[i * 3], v2[i * 3 + 1], v2[i * 3 + 2]});
        refs.push_back({b, i});
    }
    // max-heap on box surface area: always split the fattest box
    auto cmp = [](const Ref& a, const Ref& b) {
        return a.box.area() < b.box.area();
    };
    std::make_heap(refs.begin(), refs.end(), cmp);

    // Clip the triangle polygon to a half-space and grow the clipped box.
    auto clipped_box = [](const Vec3* tri, int axis, float plane, bool keep_lo,
                          const AABB& parent) {
        AABB out;
        for (int e = 0; e < 3; ++e) {
            Vec3 a = tri[e], b = tri[(e + 1) % 3];
            float va = axis == 0 ? a.x : (axis == 1 ? a.y : a.z);
            float vb = axis == 0 ? b.x : (axis == 1 ? b.y : b.z);
            bool ina = keep_lo ? (va <= plane) : (va >= plane);
            bool inb = keep_lo ? (vb <= plane) : (vb >= plane);
            if (ina) out.grow(a);
            if (ina != inb) {
                float t = (plane - va) / (vb - va);
                out.grow(Vec3{a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
                              a.z + t * (b.z - a.z)});
            }
        }
        // stay inside the parent reference box (repeated splits clip
        // against every ancestor plane)
        out.lo = vmax(out.lo, parent.lo);
        out.hi = vmin(out.hi, parent.hi);
        return out;
    };

    std::vector<Ref> done;  // references that refused to split further
    done.reserve((size_t)max_refs);
    while (!refs.empty() && (int)(refs.size() + done.size()) < max_refs) {
        std::pop_heap(refs.begin(), refs.end(), cmp);
        Ref r = refs.back();
        refs.pop_back();
        Vec3 ext = {r.box.hi.x - r.box.lo.x, r.box.hi.y - r.box.lo.y,
                    r.box.hi.z - r.box.lo.z};
        int axis = 0;
        float w = ext.x;
        if (ext.y > w) { axis = 1; w = ext.y; }
        if (ext.z > w) { axis = 2; w = ext.z; }
        if (w < 1e-6f) {  // the fattest leftover is tiny: everything is
            done.push_back(r);
            break;
        }
        int i = r.tri;
        Vec3 tri[3] = {{v0[i * 3], v0[i * 3 + 1], v0[i * 3 + 2]},
                       {v1[i * 3], v1[i * 3 + 1], v1[i * 3 + 2]},
                       {v2[i * 3], v2[i * 3 + 1], v2[i * 3 + 2]}};
        float plane = axis == 0 ? (r.box.lo.x + r.box.hi.x) * 0.5f
                    : axis == 1 ? (r.box.lo.y + r.box.hi.y) * 0.5f
                                : (r.box.lo.z + r.box.hi.z) * 0.5f;
        AABB lo_box = clipped_box(tri, axis, plane, true, r.box);
        AABB hi_box = clipped_box(tri, axis, plane, false, r.box);
        bool lo_ok = lo_box.hi.x >= lo_box.lo.x;
        bool hi_ok = hi_box.hi.x >= hi_box.lo.x;
        if (lo_ok && hi_ok) {
            refs.push_back({lo_box, i});
            std::push_heap(refs.begin(), refs.end(), cmp);
            refs.push_back({hi_box, i});
            std::push_heap(refs.begin(), refs.end(), cmp);
        } else {
            done.push_back(r);  // degenerate clip: keep as-is
        }
    }
    for (const Ref& r : refs) done.push_back(r);

    int n = (int)done.size();
    for (int i = 0; i < n; ++i) {
        ref_tri[i] = done[i].tri;
        ref_min[i * 3] = done[i].box.lo.x;
        ref_min[i * 3 + 1] = done[i].box.lo.y;
        ref_min[i * 3 + 2] = done[i].box.lo.z;
        ref_max[i * 3] = done[i].box.hi.x;
        ref_max[i * 3 + 1] = done[i].box.hi.y;
        ref_max[i * 3 + 2] = done[i].box.hi.z;
    }
    return n;
}

// FNV-1a 64-bit checksum (scene-change detection; DebugLog-free).
uint64_t rtvs_fnv1a(const uint8_t* data, uint64_t len) {
    uint64_t h = 14695981039346656037ull;
    for (uint64_t i = 0; i < len; ++i) {
        h ^= data[i];
        h *= 1099511628211ull;
    }
    return h;
}

}  // extern "C"

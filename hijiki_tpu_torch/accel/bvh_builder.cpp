// Native binned-SAH BVH builder with threaded (stackless) preorder flatten.
//
// C++ twin of hijiki_tpu/accel/bvh.py::build_bvh — the one host component
// where the reference's native speed plausibly matters (the reference builds
// its BVH with the Rust `bvh` crate, src/main.rs:198-244). Exposed through a
// plain C ABI and loaded via ctypes (no pybind11 in this image).
//
// Same algorithm as the Python builder: 16-bin SAH on the widest centroid
// axis, median-split fallback on degenerate centroid extents, leaves of up to
// `leaf_size` primitives, preorder layout with exit indices (root exit =
// num_nodes).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kNumBins = 16;

struct BuildNode {
  float bmin[3], bmax[3];
  int32_t left = -1, right = -1;
  int32_t first = -1, count = 0;
  int64_t size = 1;  // subtree size (nodes)
};

struct Builder {
  const float* aabb_min;
  const float* aabb_max;
  std::vector<float> centroid;
  int32_t n;
  int32_t leaf_size;
  std::vector<BuildNode> nodes;
  std::vector<int32_t> order;

  float cent(int64_t id, int axis) const { return centroid[3 * id + axis]; }

  int32_t alloc() {
    nodes.emplace_back();
    return static_cast<int32_t>(nodes.size()) - 1;
  }

  void build(int32_t node, std::vector<int32_t>& ids) {
    BuildNode& nd = nodes[node];
    for (int a = 0; a < 3; a++) {
      nd.bmin[a] = std::numeric_limits<float>::infinity();
      nd.bmax[a] = -std::numeric_limits<float>::infinity();
    }
    for (int32_t id : ids) {
      for (int a = 0; a < 3; a++) {
        nd.bmin[a] = std::min(nd.bmin[a], aabb_min[3 * id + a]);
        nd.bmax[a] = std::max(nd.bmax[a], aabb_max[3 * id + a]);
      }
    }
    if (static_cast<int32_t>(ids.size()) <= leaf_size) {
      nd.first = static_cast<int32_t>(order.size());
      nd.count = static_cast<int32_t>(ids.size());
      order.insert(order.end(), ids.begin(), ids.end());
      return;
    }

    // centroid bounds
    double cmin[3], cmax[3];
    for (int a = 0; a < 3; a++) {
      cmin[a] = std::numeric_limits<double>::infinity();
      cmax[a] = -std::numeric_limits<double>::infinity();
    }
    for (int32_t id : ids) {
      for (int a = 0; a < 3; a++) {
        cmin[a] = std::min(cmin[a], (double)cent(id, a));
        cmax[a] = std::max(cmax[a], (double)cent(id, a));
      }
    }
    int axis = 0;
    double extent = -1;
    for (int a = 0; a < 3; a++) {
      if (cmax[a] - cmin[a] > extent) {
        extent = cmax[a] - cmin[a];
        axis = a;
      }
    }

    std::vector<int32_t> left_ids, right_ids;
    if (extent > 0) {
      // binned SAH
      double scale = kNumBins * (1.0 - 1e-6) / extent;
      double bin_min[kNumBins][3], bin_max[kNumBins][3];
      int64_t bin_cnt[kNumBins] = {0};
      for (int b = 0; b < kNumBins; b++)
        for (int a = 0; a < 3; a++) {
          bin_min[b][a] = std::numeric_limits<double>::infinity();
          bin_max[b][a] = -std::numeric_limits<double>::infinity();
        }
      std::vector<int8_t> bin_of(ids.size());
      for (size_t i = 0; i < ids.size(); i++) {
        int32_t id = ids[i];
        int b = (int)((cent(id, axis) - cmin[axis]) * scale);
        b = std::min(std::max(b, 0), kNumBins - 1);
        bin_of[i] = (int8_t)b;
        bin_cnt[b]++;
        for (int a = 0; a < 3; a++) {
          bin_min[b][a] = std::min(bin_min[b][a], (double)aabb_min[3 * id + a]);
          bin_max[b][a] = std::max(bin_max[b][a], (double)aabb_max[3 * id + a]);
        }
      }
      auto area = [](const double mn[3], const double mx[3]) {
        double d0 = std::max(mx[0] - mn[0], 0.0);
        double d1 = std::max(mx[1] - mn[1], 0.0);
        double d2 = std::max(mx[2] - mn[2], 0.0);
        return d0 * d1 + d1 * d2 + d2 * d0;
      };
      // prefix/suffix sweeps
      double lmin[kNumBins][3], lmax[kNumBins][3], rmin[kNumBins][3], rmax[kNumBins][3];
      int64_t lcnt[kNumBins], rcnt[kNumBins];
      for (int a = 0; a < 3; a++) {
        lmin[0][a] = bin_min[0][a];
        lmax[0][a] = bin_max[0][a];
        rmin[kNumBins - 1][a] = bin_min[kNumBins - 1][a];
        rmax[kNumBins - 1][a] = bin_max[kNumBins - 1][a];
      }
      lcnt[0] = bin_cnt[0];
      rcnt[kNumBins - 1] = bin_cnt[kNumBins - 1];
      for (int b = 1; b < kNumBins; b++) {
        lcnt[b] = lcnt[b - 1] + bin_cnt[b];
        for (int a = 0; a < 3; a++) {
          lmin[b][a] = std::min(lmin[b - 1][a], bin_min[b][a]);
          lmax[b][a] = std::max(lmax[b - 1][a], bin_max[b][a]);
        }
      }
      for (int b = kNumBins - 2; b >= 0; b--) {
        rcnt[b] = rcnt[b + 1] + bin_cnt[b];
        for (int a = 0; a < 3; a++) {
          rmin[b][a] = std::min(rmin[b + 1][a], bin_min[b][a]);
          rmax[b][a] = std::max(rmax[b + 1][a], bin_max[b][a]);
        }
      }
      double best_cost = std::numeric_limits<double>::infinity();
      int best = -1;
      for (int b = 0; b < kNumBins - 1; b++) {
        if (lcnt[b] == 0 || rcnt[b + 1] == 0) continue;
        double c = area(lmin[b], lmax[b]) * lcnt[b] +
                   area(rmin[b + 1], rmax[b + 1]) * rcnt[b + 1];
        if (c < best_cost) {
          best_cost = c;
          best = b;
        }
      }
      if (best >= 0) {
        for (size_t i = 0; i < ids.size(); i++) {
          (bin_of[i] <= best ? left_ids : right_ids).push_back(ids[i]);
        }
      }
    }
    if (left_ids.empty() || right_ids.empty()) {
      // degenerate: median split by centroid (stable)
      std::vector<int32_t> sorted = ids;
      std::stable_sort(sorted.begin(), sorted.end(), [&](int32_t x, int32_t y) {
        return cent(x, axis) < cent(y, axis);
      });
      size_t half = sorted.size() / 2;
      left_ids.assign(sorted.begin(), sorted.begin() + half);
      right_ids.assign(sorted.begin() + half, sorted.end());
    }

    ids.clear();
    ids.shrink_to_fit();
    int32_t li = alloc();
    int32_t ri = alloc();
    nodes[node].left = li;
    nodes[node].right = ri;
    build(li, left_ids);
    build(ri, right_ids);
    nodes[node].size = 1 + nodes[li].size + nodes[ri].size;
  }
};

}  // namespace

extern "C" {

// Returns the number of flat nodes, or -1 on error. Output arrays must be
// sized for the worst case: 2*n_prims - 1 nodes (leaf_size >= 1).
int32_t hijiki_build_bvh(const float* aabb_min, const float* aabb_max,
                         int32_t n_prims, int32_t leaf_size, float* out_min,
                         float* out_max, int32_t* out_first, int32_t* out_count,
                         int32_t* out_exit, int32_t* out_order) {
  if (n_prims <= 0 || leaf_size < 1) return -1;
  Builder b;
  b.aabb_min = aabb_min;
  b.aabb_max = aabb_max;
  b.n = n_prims;
  b.leaf_size = leaf_size;
  b.centroid.resize(3 * (size_t)n_prims);
  for (int64_t i = 0; i < 3 * (int64_t)n_prims; i++)
    b.centroid[i] = 0.5f * (aabb_min[i] + aabb_max[i]);
  b.nodes.reserve(2 * (size_t)n_prims);
  b.order.reserve(n_prims);

  std::vector<int32_t> ids(n_prims);
  for (int32_t i = 0; i < n_prims; i++) ids[i] = i;
  int32_t root = b.alloc();
  b.build(root, ids);

  // preorder flatten with exit threading
  const int32_t num = static_cast<int32_t>(b.nodes.size());
  struct Item {
    int32_t tree, exit;
  };
  std::vector<Item> stack;
  stack.push_back({root, num});
  int32_t out = 0;
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    const BuildNode& nd = b.nodes[it.tree];
    std::memcpy(out_min + 3 * out, nd.bmin, 12);
    std::memcpy(out_max + 3 * out, nd.bmax, 12);
    out_exit[out] = it.exit;
    if (nd.left < 0) {
      out_first[out] = nd.first;
      out_count[out] = nd.count;
    } else {
      out_first[out] = out + 1;
      out_count[out] = 0;
      int32_t right_pos = out + 1 + static_cast<int32_t>(b.nodes[nd.left].size);
      stack.push_back({nd.right, it.exit});
      stack.push_back({nd.left, right_pos});
    }
    out++;
  }
  std::memcpy(out_order, b.order.data(), sizeof(int32_t) * (size_t)n_prims);
  return num;
}

}  // extern "C"

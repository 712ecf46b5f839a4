// Native host-side acceleration-structure builder.
//
// The reference's hot host path is C++ (binned-SAH BVH build,
// tests/regression/raytracing/bvh.cpp:30-213); this is the framework's
// native equivalent, exposed through a C ABI consumed via ctypes
// (vortex_rt_tpu/runtime/native.py).  Semantics match accel/bvh2.py
// exactly: binned SAH (BINS bins over the centroid extent, all 3 axes,
// cost = leftArea*leftCount + rightArea*rightCount), split accepted only
// when it beats area(parent)*count, median-split fallback on the widest
// centroid axis, and an index permutation instead of in-place triangle
// reordering.  Node layout: flat SoA, DFS order, children adjacent.
//
// Build: csrc/build.sh  (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float area(const Vec3 &lo, const Vec3 &hi) {
  float ex = hi.x - lo.x, ey = hi.y - lo.y, ez = hi.z - lo.z;
  if (ex < 0 || ey < 0 || ez < 0) return 0.f;
  return ex * ey + ey * ez + ez * ex;
}
static inline float axis_of(const Vec3 &v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}

struct Builder {
  const Vec3 *tmin, *tmax, *cen;
  int bins, max_leaf;
  std::vector<int> order;
  std::vector<Vec3> node_min, node_max;
  std::vector<int> left_first, tri_count;

  int push(int lo, int hi) {
    Vec3 mn = tmin[order[lo]], mx = tmax[order[lo]];
    for (int i = lo + 1; i < hi; ++i) {
      mn = vmin(mn, tmin[order[i]]);
      mx = vmax(mx, tmax[order[i]]);
    }
    node_min.push_back(mn);
    node_max.push_back(mx);
    left_first.push_back(lo);
    tri_count.push_back(hi - lo);
    return (int)node_min.size() - 1;
  }

  // best binned-SAH split; returns true with (axis, thr) or false
  bool best_split(int lo, int hi, int &axis_out, float &thr_out,
                  float &cost_out) {
    const int B = bins;
    bool found = false;
    float best_cost = std::numeric_limits<float>::infinity();
    for (int axis = 0; axis < 3; ++axis) {
      float cmin = std::numeric_limits<float>::infinity();
      float cmax = -cmin;
      for (int i = lo; i < hi; ++i) {
        float c = axis_of(cen[order[i]], axis);
        cmin = std::min(cmin, c);
        cmax = std::max(cmax, c);
      }
      if (cmax <= cmin) continue;
      float scale = B / (cmax - cmin);
      std::vector<int> counts(B, 0);
      std::vector<Vec3> bmin(B, {1e30f, 1e30f, 1e30f});
      std::vector<Vec3> bmax(B, {-1e30f, -1e30f, -1e30f});
      for (int i = lo; i < hi; ++i) {
        int t = order[i];
        int b = std::min((int)((axis_of(cen[t], axis) - cmin) * scale), B - 1);
        counts[b]++;
        bmin[b] = vmin(bmin[b], tmin[t]);
        bmax[b] = vmax(bmax[b], tmax[t]);
      }
      // prefix/suffix sweeps over the B-1 planes
      std::vector<int> lcnt(B), rcnt(B);
      std::vector<Vec3> lmin(B), lmax(B), rmin(B), rmax(B);
      int acc = 0;
      Vec3 mn = {1e30f, 1e30f, 1e30f}, mx = {-1e30f, -1e30f, -1e30f};
      for (int b = 0; b < B; ++b) {
        acc += counts[b];
        mn = vmin(mn, bmin[b]);
        mx = vmax(mx, bmax[b]);
        lcnt[b] = acc;
        lmin[b] = mn;
        lmax[b] = mx;
      }
      acc = 0;
      mn = {1e30f, 1e30f, 1e30f};
      mx = {-1e30f, -1e30f, -1e30f};
      for (int b = B - 1; b >= 0; --b) {
        acc += counts[b];
        mn = vmin(mn, bmin[b]);
        mx = vmax(mx, bmax[b]);
        rcnt[b] = acc;
        rmin[b] = mn;
        rmax[b] = mx;
      }
      for (int k = 0; k < B - 1; ++k) {
        int lc = lcnt[k], rc = rcnt[k + 1];
        if (lc == 0 || rc == 0) continue;
        float cost = area(lmin[k], lmax[k]) * lc
                   + area(rmin[k + 1], rmax[k + 1]) * rc;
        if (cost < best_cost) {
          best_cost = cost;
          axis_out = axis;
          thr_out = cmin + (k + 1) / scale;
          found = true;
        }
      }
    }
    cost_out = best_cost;
    return found;
  }

  void build(int root_lo, int root_hi) {
    std::vector<int> stack{push(root_lo, root_hi)};
    while (!stack.empty()) {
      int ni = stack.back();
      stack.pop_back();
      int lo = left_first[ni], n = tri_count[ni], hi = lo + n;
      if (n <= max_leaf) continue;
      int axis;
      float thr, cost;
      bool ok = best_split(lo, hi, axis, thr, cost);
      if (ok) {
        float parent_cost = area(node_min[ni], node_max[ni]) * n;
        if (cost >= parent_cost) ok = false;
      }
      int mid;
      if (ok) {
        auto it = std::stable_partition(
            order.begin() + lo, order.begin() + hi,
            [&](int t) { return axis_of(cen[t], axis) < thr; });
        mid = (int)(it - order.begin());
        if (mid == lo || mid == hi) continue;  // degenerate: keep leaf
      } else {
        // median split on the widest centroid axis (bvh.cpp:372-384)
        Vec3 cmn = cen[order[lo]], cmx = cen[order[lo]];
        for (int i = lo + 1; i < hi; ++i) {
          cmn = vmin(cmn, cen[order[i]]);
          cmx = vmax(cmx, cen[order[i]]);
        }
        float ex = cmx.x - cmn.x, ey = cmx.y - cmn.y, ez = cmx.z - cmn.z;
        int a = (ex >= ey && ex >= ez) ? 0 : (ey >= ez ? 1 : 2);
        // identical centroids still split by index: consumers rely on
        // leaves respecting max_leaf (TLAS instance leaves hold ONE)
        if (axis_of(cmx, a) > axis_of(cmn, a)) {
          std::stable_sort(order.begin() + lo, order.begin() + hi,
                           [&](int s, int t) {
                             return axis_of(cen[s], a) < axis_of(cen[t], a);
                           });
        }
        mid = lo + n / 2;
      }
      int l = push(lo, mid);
      push(mid, hi);
      left_first[ni] = l;
      tri_count[ni] = 0;
      stack.push_back(l + 1);
      stack.push_back(l);
    }
  }
};

}  // namespace

extern "C" {

// Returns number of nodes written, or -needed if cap too small, -1 on error.
int vrt_build_bvh2(const float *v0, const float *v1, const float *v2, int t,
                   int max_leaf, int bins, float *out_node_min,
                   float *out_node_max, int *out_left_first,
                   int *out_tri_count, int *out_tri_idx, int cap) {
  if (t <= 0 || bins < 2 || max_leaf < 1) return -1;
  std::vector<Vec3> tmin(t), tmax(t), cen(t);
  for (int i = 0; i < t; ++i) {
    Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    Vec3 b{v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]};
    Vec3 c{v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]};
    tmin[i] = vmin(vmin(a, b), c);
    tmax[i] = vmax(vmax(a, b), c);
    cen[i] = {(a.x + b.x + c.x) / 3.f, (a.y + b.y + c.y) / 3.f,
              (a.z + b.z + c.z) / 3.f};
  }
  Builder bld;
  bld.tmin = tmin.data();
  bld.tmax = tmax.data();
  bld.cen = cen.data();
  bld.bins = bins;
  bld.max_leaf = max_leaf;
  bld.order.resize(t);
  for (int i = 0; i < t; ++i) bld.order[i] = i;
  bld.node_min.reserve(2 * t);
  bld.build(0, t);

  int n = (int)bld.node_min.size();
  if (n > cap) return -n;
  std::memcpy(out_node_min, bld.node_min.data(), n * 3 * sizeof(float));
  std::memcpy(out_node_max, bld.node_max.data(), n * 3 * sizeof(float));
  std::memcpy(out_left_first, bld.left_first.data(), n * sizeof(int));
  std::memcpy(out_tri_count, bld.tri_count.data(), n * sizeof(int));
  std::memcpy(out_tri_idx, bld.order.data(), t * sizeof(int));
  return n;
}

// Fast OBJ triangle counting / parsing could live here too; the geometry
// builder is the measured host hotspot so it comes first.

}  // extern "C"

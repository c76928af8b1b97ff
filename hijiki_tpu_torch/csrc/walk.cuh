// The per-thread closest/any-hit walk of the trace rows, shared by the
// megakernel (megakernel.cu: K1, K2, K4, K5 and their sorted variants) and
// the walk-isolation probe (probe_walk.cu: walk_isolate, K10b).
//
// Port of the walk inside hijiki_tpu/ops/pallas_megakernel.py::_bounce_loop:
// _analytic_pretest (analytic_test over the baked spheres/quads), _prim_test
// on a classic row, _octant_base and the stackless walk itself. The plain
// PyTorch twin is hijiki_tpu_torch/ops/megakernel.py (_analytic_test,
// _prim_test, _octant_base, _walk). Numerics as noted in megakernel.cu:
// --fmad=false, IEEE division and sqrtf, NaN-propagating min/max, f32
// constants as exact hex literals.
//
// The row step (its primitives in row.cuh, which K6 shares): a row's
// columns 0-11 come in as three 128-bit loads (the interior row's box in
// 0-5, kind in 9, exit pointer in 10, the prim's edges in 3-8), and a prim
// row adds one more for its plane normal, where a 32-bit load per column
// took eight for an interior row. The slab test's min/max are single
// min.NaN/max.NaN instructions, where jmin/jmax took several each. On the
// H100 the interior step went from 77 SASS instructions to 42 (PERF.md).
//
// prim_test, octant_base and walk take template parameters whose defaults
// are the megakernel's (32-column rows, the plane normal in columns 29-31,
// the prim test on, a thread walking alone), so K1-K5 compile to the code
// they always had; walk_isolate also instantiates the 16-column table of
// tools/walk_probe.py::make_w16_scene (normal in columns 11-13), the walk
// without its prim test (every prim row misses, as patch_no_test does) and
// the warp walking as one 32-ray packet.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "row.cuh"

namespace {

constexpr float kBig = 0x1.c363ccp+127f;     // f32(3e38)
constexpr int kAnaStride = 16;
constexpr int kEmStride = 28;
constexpr unsigned kFull = 0xffffffffu;  // every lane of a warp

struct Scene {
  const float* rows;
  const float* consts;
  int total_rows, tbl_rows, ntab, analytic_mode;
  int na, ne, nd, ncb, ndl, nem;
  int ana_off, em_off, d_off, cb_off, dl_off, emi_off, sort_off;
};

// the vote of a group of kG threads: a thread alone (1) or a warp (32)
template <int kG>
__device__ __forceinline__ bool group_any(bool p) {
  if constexpr (kG == 1) return p;
  else return __any_sync(kFull, p);
}
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// one baked analytic prim (_analytic_pretest's per-prim test)
__device__ __forceinline__ bool analytic_test(const float* a, float ox, float oy,
                                              float oz, float dx, float dy,
                                              float dz, float tmin, float best_t,
                                              float& pt, float& pu, float& pv) {
  float rx = ox - a[3], ry = oy - a[4], rz = oz - a[5];
  if (a[0] == 0.0f) {  // sphere: a[12] = f32(r * r)
    float sb = 2.0f * dot3(dx, dy, dz, rx, ry, rz);
    float sc = dot3(rx, ry, rz, rx, ry, rz) - a[12];
    float disc = sb * sb - 4.0f * sc;
    float sq = sqrtf(jmax(disc, 0.0f));
    float st0 = -0.5f * (sb + sq);
    float st1 = -0.5f * (sb - sq);
    bool ok0 = (tmin <= st0) && (st0 <= best_t);
    bool ok1 = (tmin <= st1) && (st1 <= best_t);
    pt = ok0 ? st0 : st1;
    pu = 0.0f;
    pv = 0.0f;
    return (disc >= 0.0f) && (ok0 || ok1);
  }
  // quad: origin a[3..5], edge1 a[6..8], edge2 a[9..11], normal a[12..14]
  float qx = ry * dz - rz * dy;
  float qy = rz * dx - rx * dz;
  float qz = rx * dy - ry * dx;
  float dd = 1.0f / (dx * a[12] + dy * a[13] + dz * a[14]);
  pu = -dd * (qx * a[9] + qy * a[10] + qz * a[11]);
  pv = dd * (qx * a[6] + qy * a[7] + qz * a[8]);
  pt = -dd * (a[12] * rx + a[13] * ry + a[14] * rz);
  return (pu >= 0.0f) && (pu <= 1.0f) && (pv >= 0.0f) && (pv <= 1.0f) &&
         (tmin <= pt) && (pt <= best_t);
}

// _analytic_pretest: every baked prim against the ray, closest accept into
// (bt, bu, bv, wrow = total_rows + k); the caller sets the miss values
__device__ __forceinline__ void analytic_pretest(const Scene& S, float ox, float oy,
                                                 float oz, float dx, float dy,
                                                 float dz, float tmin, float& bt,
                                                 float& bu, float& bv, int& wrow) {
  for (int k = 0; k < S.na; ++k) {
    const float* a = S.consts + S.ana_off + k * kAnaStride;
    float pt, pu, pv;
    if (analytic_test(a, ox, oy, oz, dx, dy, dz, tmin, bt, pt, pu, pv) &&
        pt < bt) {
      bt = pt;
      bu = pu;
      bv = pv;
      wrow = S.total_rows + k;
    }
  }
}

// _prim_test on a classic row whose columns 0-11 are c0, c1, c2 (row4 at 0,
// 4, 8); kNrm: the column of the baked plane normal (29 in the 32-column
// table, 11 in the 16-column probe table), loaded here
template <int kNrm = 29>
__device__ __forceinline__ bool prim_test(const Scene& S, const float* r,
                                          const float4& c0, const float4& c1,
                                          const float4& c2, float ox, float oy,
                                          float oz, float dx, float dy, float dz,
                                          float tmin, float best_t, float& pt,
                                          float& pu, float& pv) {
  float rx = ox - c0.x, ry = oy - c0.y, rz = oz - c0.z;
  float kind = c2.y;
  if (!S.analytic_mode && kind == 0.0f) {  // sphere row, radius in col 3
    float radius = c0.w;
    float sb = 2.0f * dot3(dx, dy, dz, rx, ry, rz);
    float sc = dot3(rx, ry, rz, rx, ry, rz) - radius * radius;
    float disc = sb * sb - 4.0f * sc;
    float sq = sqrtf(jmax(disc, 0.0f));
    float st0 = -0.5f * (sb + sq);
    float st1 = -0.5f * (sb - sq);
    bool ok0 = (tmin <= st0) && (st0 <= best_t);
    bool ok1 = (tmin <= st1) && (st1 <= best_t);
    pt = ok0 ? st0 : st1;
    pu = 0.0f;
    pv = 0.0f;
    return (disc >= 0.0f) && (ok0 || ok1);
  }
  static_assert(kNrm == 29 || kNrm == 11, "the normal's column");
  float nx, ny, nz;
  if constexpr (kNrm == 29) {
    const float4 c7 = row4(r, 28);
    nx = c7.y;
    ny = c7.z;
    nz = c7.w;
  } else {
    const float4 c3 = row4(r, 12);
    nx = c2.w;
    ny = c3.x;
    nz = c3.y;
  }
  float qx = ry * dz - rz * dy;
  float qy = rz * dx - rx * dz;
  float qz = rx * dy - ry * dx;
  float dd = 1.0f / (dx * nx + dy * ny + dz * nz);
  float u = -dd * (qx * c1.z + qy * c1.w + qz * c2.x);
  float v = dd * (qx * c0.w + qy * c1.x + qz * c1.y);
  float t = -dd * (nx * rx + ny * ry + nz * rz);
  pt = t;
  pu = u;
  pv = v;
  bool in_tri = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
  if (S.analytic_mode) return in_tri && (tmin <= t);
  bool in_quad = (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (v <= 1.0f);
  bool ok = (kind == 2.0f) ? in_tri : in_quad;
  return ok && (tmin <= t) && (t <= best_t);
}

// the octant table of the ray's direction; a warp walking as one packet
// (kG = 32) takes its majority direction (_octant_base's vote: more rays
// with d > 0 than with d <= 0, per axis)
template <int kG = 1>
__device__ __forceinline__ int octant_base(const Scene& S, float dx, float dy,
                                           float dz) {
  if (S.ntab == 1) return 0;
  if constexpr (kG == 1) {
    int oct = (dx > 0.0f) + 2 * (dy > 0.0f) + 4 * (dz > 0.0f);
    return oct * S.tbl_rows;
  } else {
    const int vx = 2 * __popc(__ballot_sync(kFull, dx > 0.0f)) > 32;
    const int vy = 2 * __popc(__ballot_sync(kFull, dy > 0.0f)) > 32;
    const int vz = 2 * __popc(__ballot_sync(kFull, dz > 0.0f)) > 32;
    return (vx + 2 * vy + 4 * vz) * S.tbl_rows;
  }
}

// The stackless walk. Closest hit (any_hit false) updates t/u/v/wrow;
// any-hit sets `hit` and stops at the first accept. Returns rows visited.
// kW: floats per row; kNrm: the normal's column; kTest = false makes every
// prim row miss (the walk without its prim test). kG = 32: the warp walks
// as one 32-ray packet (the TPU's packet walk at 32 lanes): one cursor and
// row for the warp, descend when any ray's slab test passes, accept per ray;
// every lane of the warp must walk, closest hit only.
template <int kW = kRowW, int kNrm = 29, bool kTest = true, int kG = 1>
__device__ float walk(const Scene& S, float ox, float oy, float oz, float dx,
                      float dy, float dz, float tmin, float tmax, bool any_hit,
                      bool& hit, float& bt, float& bu, float& bv, int& wrow) {
  if (!(tmax >= 0.0f) || (any_hit && hit)) return 0.0f;
  float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  float tox = -ox * ix, toy = -oy * iy, toz = -oz * iz;
  int cur = octant_base<kG>(S, dx, dy, dz);
  int end = cur + S.tbl_rows;
  float nit = 0.0f;
  while (cur < end) {
    const float* r = S.rows + static_cast<size_t>(cur) * kW;
    const float4 c0 = row4(r, 0), c1 = row4(r, 4), c2 = row4(r, 8);
    nit = nit + 1.0f;
    int nexit = static_cast<int>(c2.z);
    float best_t = any_hit ? tmax : bt;
    if (c2.y < 0.0f) {  // interior row: slab test on its box
      float ax = c0.x * ix + tox, bx = c0.w * ix + tox;
      float ay = c0.y * iy + toy, by = c1.x * iy + toy;
      float az = c0.z * iz + toz, bz = c1.y * iz + toz;
      float t0 = nan_max(nan_max(nan_min(ax, bx), nan_min(ay, by)), nan_min(az, bz));
      float t1 = nan_min(nan_min(nan_max(ax, bx), nan_max(ay, by)), nan_max(az, bz));
      bool slab = (t0 < t1 + kEps) && (t0 < best_t) && (t1 > tmin);
      cur = group_any<kG>(slab) ? cur + 1 : nexit;
      continue;
    }
    float pt, pu, pv;
    if (kTest &&
        prim_test<kNrm>(S, r, c0, c1, c2, ox, oy, oz, dx, dy, dz, tmin, best_t, pt,
                        pu, pv) &&
        pt < best_t) {
      if (any_hit) {
        hit = true;
        break;
      }
      bt = pt;
      bu = pu;
      bv = pv;
      wrow = cur;
    }
    cur = nexit;
  }
  return nit;
}

inline Scene make_scene(const float* rows, const float* consts, int total_rows,
                        int tbl_rows, int ntab, int analytic_mode, int na,
                        int ne, int nd, int ncb, int ndl, int nem) {
  Scene S;
  S.rows = rows;
  S.consts = consts;
  S.total_rows = total_rows;
  S.tbl_rows = tbl_rows;
  S.ntab = ntab;
  S.analytic_mode = analytic_mode;
  S.na = na;
  S.ne = ne;
  S.nd = nd;
  S.ncb = ncb;
  S.ndl = ndl;
  S.nem = nem;
  // constants buffer: camera (15), analytic, emitters, diffuse, checkerboard,
  // dielectric, emissive (hijiki_tpu_torch/ops/megakernel.py::mega_scene)
  S.ana_off = 15;
  S.em_off = S.ana_off + na * kAnaStride;
  S.d_off = S.em_off + ne * kEmStride;
  S.cb_off = S.d_off + nd * 3;
  S.dl_off = S.cb_off + ncb * 8;
  S.emi_off = S.dl_off + ndl * 4;
  S.sort_off = S.emi_off + nem * 3;  // lane-sort key: box min xyz, scale xyz
  return S;
}

}  // namespace

// the scene arguments of every C entry point that takes a Scene
// (ops/megakernel.py::_scene_args, after the rows and constants pointers)
#define SCENE_ARGS                                                             \
  const float *rows, const float *consts, int total_rows, int tbl_rows,        \
      int ntab, int analytic_mode, int na, int ne, int nd, int ncb, int ndl,   \
      int nem
#define SCENE_CALL                                                             \
  make_scene(rows, consts, total_rows, tbl_rows, ntab, analytic_mode, na, ne,  \
             nd, ncb, ndl, nem)

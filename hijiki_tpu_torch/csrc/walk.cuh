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
//
// The any-hit walks also report the row where they accepted (in wrow), which
// the megakernel's shadow-ray occlusion cache predicts from (megakernel.cu
// trace_any<.., kCache>); a caller that ignores it compiles to the walk it
// had.
//
// walk_packed<kFmt> is the walk over the packed trace-row formats of
// scene/compile.py::build_packed_trace_rows (_prim_test with packed = 1, 3,
// 4, 12): a prim row holds 1, 3, 4 or 12 triangles in a 16-, 32-, 64- or
// 128-column row; interior rows are the classic ones (box in columns 0-5,
// -1 in 9, exit in 10). Its prims are tested one at a time and reduced by
// a strict-min-t tournament in which the earlier prim wins a tie (the
// sequential walk's outcome over the same leaf), so a pad (a duplicate in
// format 4, a zero triangle in 3 and 12) never wins; the winner's payload
// slot replaces the row index as the winner. The prims' columns are not
// 16-byte aligned past the first (format 3 at 0, 11, 20; 12 at 0 and every
// 9 from 11; 4 at 12 + 13k): the first prim comes from the row step's
// float4s, the others by scalar loads, which NVVM merges into wider loads
// where row4's 16-byte alignment proves them aligned. packed_test<kFmt,
// true> is the any-hit accept: it stops a row's test at the first prim
// with a hit below tmax (the tournament's min t is below tmax exactly when
// some prim's is, so the hit flag and the accepting row are the
// tournament's), and the later prims are neither loaded nor tested. The
// any-hit walks take it where walk_packed's kStop says (megakernel.cu
// kAnyStop); elsewhere they run the tournament and compare its t.

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
  // the packed format (0: classic rows), the payload section's rows (it
  // starts at ntab * tbl_rows), the shadow-visibility boxes a launch tests,
  // the dedicated PACKED3 shadow table (null: shadow rays walk `rows`)
  int packed, n_pay, nbox;
  const float* shadow_rows;
  int shadow_n;
  // the launch's shadow-ray occlusion cache (the C entry picks the kCache
  // instantiation from it) and the skip-all probe switch (read at run time)
  int cache, skip_all;
  int ana_off, em_off, d_off, cb_off, dl_off, emi_off, sort_off, box_off;
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
// (bt, bu, bv, wrow = enc + k; enc: total_rows, or a packed table's n_pay);
// the caller sets the miss values
__device__ __forceinline__ void analytic_pretest(const Scene& S, int enc, float ox,
                                                 float oy, float oz, float dx,
                                                 float dy, float dz, float tmin,
                                                 float& bt, float& bu, float& bv,
                                                 int& wrow) {
  for (int k = 0; k < S.na; ++k) {
    const float* a = S.consts + S.ana_off + k * kAnaStride;
    float pt, pu, pv;
    if (analytic_test(a, ox, oy, oz, dx, dy, dz, tmin, bt, pt, pu, pv) &&
        pt < bt) {
      bt = pt;
      bu = pu;
      bv = pv;
      wrow = enc + k;
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
// any-hit sets `hit`, and `wrow` to the accepting row, and stops at the first
// accept. Returns rows visited.
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
        wrow = cur;
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

// ---------------------------------------------------------- packed rows ----

// a packed format's prims a row and row width in floats (1: SLIM, 16
// columns; 3: PACKED3, 32; 4: PACKED4, 64; 12: PACKED12, 128)
template <int kFmt>
__host__ __device__ constexpr int packed_n() {
  return kFmt == 1 ? 1 : kFmt == 3 ? 3 : kFmt == 4 ? 4 : 12;
}
template <int kFmt>
__host__ __device__ constexpr int packed_width() {
  return kFmt == 1 ? 16 : kFmt == 3 ? 32 : kFmt == 4 ? 64 : 128;
}
// the first column of prim k; the column of prim 0's slot in the formats
// whose slots run on from it (the 64-wide format keeps a slot a prim, at
// its base + 12)
template <int kFmt>
__host__ __device__ constexpr int packed_base(int k) {
  return kFmt == 1 ? 0
         : kFmt == 3 ? (k == 0 ? 0 : k == 1 ? 11 : 20)
         : kFmt == 4 ? 12 + 13 * k
                     : (k == 0 ? 0 : 11 + 9 * (k - 1));
}
template <int kFmt>
__host__ __device__ constexpr int packed_slot_col() {
  return kFmt == 1 ? 11 : kFmt == 3 ? 29 : 110;
}

// one triangle of a packed row (v0, edge1, edge2; the plane normal
// recomputed as the twin and numpy's f32 cross compute it, or baked in
// the 64-wide format): hit with tmin <= t, the analytic-mode accept
__device__ __forceinline__ bool packed_tri(float v0x, float v0y, float v0z,
                                           float v1x, float v1y, float v1z,
                                           float v2x, float v2y, float v2z,
                                           float nx, float ny, float nz, float ox,
                                           float oy, float oz, float dx, float dy,
                                           float dz, float tmin, float& t,
                                           float& u, float& v) {
  float rx = ox - v0x, ry = oy - v0y, rz = oz - v0z;
  float qx = ry * dz - rz * dy;
  float qy = rz * dx - rx * dz;
  float qz = rx * dy - ry * dx;
  float dd = 1.0f / (dx * nx + dy * ny + dz * nz);
  u = -dd * (qx * v2x + qy * v2y + qz * v2z);
  v = dd * (qx * v1x + qy * v1y + qz * v1z);
  t = -dd * (nx * rx + ny * ry + nz * rz);
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (tmin <= t);
}

// _prim_test on a packed prim row whose columns 0-11 are c0, c1, c2: the
// tournament over its prims -> (hit, t, u, v, the winner's payload slot).
// kAny: the any-hit accept instead, true at the first prim with a hit
// below tmax (pt, pu, pv and slot left 0)
template <int kFmt, bool kAny = false>
__device__ __forceinline__ bool packed_test(const float* r, const float4& c0,
                                            const float4& c1, const float4& c2,
                                            float ox, float oy, float oz, float dx,
                                            float dy, float dz, float tmin, float tmax,
                                            float& pt, float& pu, float& pv,
                                            float& slot) {
  bool bhit = false;
  pt = pu = pv = slot = 0.0f;
#pragma unroll
  for (int k = 0; k < packed_n<kFmt>(); ++k) {
    const int B = packed_base<kFmt>(k);
    float v[9], nx, ny, nz;
    if (B == 0) {
      v[0] = c0.x; v[1] = c0.y; v[2] = c0.z; v[3] = c0.w; v[4] = c1.x;
      v[5] = c1.y; v[6] = c1.z; v[7] = c1.w; v[8] = c2.x;
    } else {
#pragma unroll
      for (int j = 0; j < 9; ++j) v[j] = __ldg(r + B + j);
    }
    if constexpr (kFmt == 4) {
      nx = __ldg(r + B + 9);
      ny = __ldg(r + B + 10);
      nz = __ldg(r + B + 11);
    } else {
      nx = v[4] * v[8] - v[5] * v[7];
      ny = v[5] * v[6] - v[3] * v[8];
      nz = v[3] * v[7] - v[4] * v[6];
    }
    float t, u, w;
    const bool h = packed_tri(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8],
                              nx, ny, nz, ox, oy, oz, dx, dy, dz, tmin, t, u, w);
    if constexpr (kAny) {
      if (h && t < tmax) return true;
    } else {
      if (h && (!bhit || t < pt)) {
        pt = t;
        pu = u;
        pv = w;
        slot = kFmt == 4 ? __ldg(r + B + 12) : static_cast<float>(k);
      }
      bhit = bhit || h;
    }
  }
  if constexpr (kAny) {
    return false;
  } else {
    if constexpr (kFmt == 1) slot = c2.w;  // column 11
    else if constexpr (kFmt != 4) slot = __ldg(r + packed_slot_col<kFmt>()) + slot;
    return bhit;
  }
}

// The stackless walk over rows [cur, end) of a packed table `rows` (the
// main table's octant table, or the dedicated shadow table); as walk(),
// with wrow the closest hit's payload slot (any hit: the accepting row).
// kTest = false makes every prim row miss, kG = 32 walks the warp as one
// packet (walk_isolate, as walk()); kStop: an any hit by packed_test's
// any-hit accept. Returns rows visited.
template <int kFmt, bool kTest = true, int kG = 1, bool kStop = false>
__device__ float walk_packed(const float* rows, int cur, int end, float ox, float oy,
                             float oz, float dx, float dy, float dz, float tmin,
                             float tmax, bool any_hit, bool& hit, float& bt,
                             float& bu, float& bv, int& wrow) {
  if (!(tmax >= 0.0f) || (any_hit && hit)) return 0.0f;
  float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  float tox = -ox * ix, toy = -oy * iy, toz = -oz * iz;
  float nit = 0.0f;
  while (cur < end) {
    const float* r = rows + static_cast<size_t>(cur) * packed_width<kFmt>();
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
    float pt, pu, pv, slot;
    if (kStop && kTest && any_hit) {
      if (packed_test<kFmt, true>(r, c0, c1, c2, ox, oy, oz, dx, dy, dz, tmin, tmax, pt,
                                  pu, pv, slot)) {
        hit = true;
        wrow = cur;
        break;
      }
    } else if (kTest &&
               packed_test<kFmt>(r, c0, c1, c2, ox, oy, oz, dx, dy, dz, tmin, tmax, pt,
                                 pu, pv, slot) &&
               pt < best_t) {
      if (any_hit) {
        hit = true;
        wrow = cur;
        break;
      }
      bt = pt;
      bu = pu;
      bv = pv;
      wrow = static_cast<int>(slot);
    }
    cur = nexit;
  }
  return nit;
}

inline Scene make_scene(const float* rows, const float* consts, int total_rows,
                        int tbl_rows, int ntab, int analytic_mode, int na,
                        int ne, int nd, int ncb, int ndl, int nem, int packed,
                        int n_pay, int nbox, const float* shadow_rows,
                        int shadow_n, int cache, int skip_all) {
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
  S.packed = packed;
  S.n_pay = n_pay;
  S.nbox = nbox;
  S.shadow_rows = shadow_rows;
  S.shadow_n = shadow_n;
  S.cache = cache;
  S.skip_all = skip_all;
  // constants buffer: camera (15), analytic, emitters, diffuse, checkerboard,
  // dielectric, emissive, lane-sort key, boxes
  // (hijiki_tpu_torch/ops/megakernel.py::mega_scene)
  S.ana_off = 15;
  S.em_off = S.ana_off + na * kAnaStride;
  S.d_off = S.em_off + ne * kEmStride;
  S.cb_off = S.d_off + nd * 3;
  S.dl_off = S.cb_off + ncb * 8;
  S.emi_off = S.dl_off + ndl * 4;
  S.sort_off = S.emi_off + nem * 3;  // lane-sort key: box min xyz, scale xyz
  S.box_off = S.sort_off + 6;        // boxes: x0, y0, z0, x1, y1, z1 each
  return S;
}

}  // namespace

// the scene arguments of every C entry point that takes a Scene
// (ops/megakernel.py::_scene_args, after the rows and constants pointers)
#define SCENE_ARGS                                                             \
  const float *rows, const float *consts, int total_rows, int tbl_rows,        \
      int ntab, int analytic_mode, int na, int ne, int nd, int ncb, int ndl,   \
      int nem, int packed, int n_pay, int nbox, const float *shadow_rows,      \
      int shadow_n, int cache, int skip_all
#define SCENE_CALL                                                             \
  make_scene(rows, consts, total_rows, tbl_rows, ntab, analytic_mode, na, ne,  \
             nd, ncb, ndl, nem, packed, n_pay, nbox, shadow_rows, shadow_n,    \
             cache, skip_all)

// Path-tracing megakernel for Hopper (sm_90a): the camera launch and the
// resume launch of the phased wavefront driver.
//
// Replaces hijiki_tpu/ops/pallas_megakernel.py::_megakernel_start (mk_start)
// and ::_megakernel_resume (mk_resume); both share bounce_loop(), the port
// of _bounce_loop with _camera_init, _analytic_pretest, the trace-row walk,
// _resolve_winners, NEE, the BSDFs and Russian roulette. The plain PyTorch
// twin of every line below is hijiki_tpu_torch/ops/megakernel.py.
//
// Design: one thread per path, 128 threads per block, the whole path state
// in registers. The TPU kernel walked 8x128-lane packets with shared
// cursors because Mosaic has no per-lane gather; here each thread walks its
// own ray over the threaded trace table (row `cur`, then `cur + 1` or the
// exit pointer in column 10 — the reference GLSL's stackless walk), reading
// the table from global memory (it fits in the 50 MB L2 many times over).
// With octant table sets each thread takes the table of its own direction
// signs. Finished and dead paths retire per thread; render_waves compacts the
// survivors between phases, which is what keeps warps full.
//
// What bounds it: the walk is a chain of dependent global loads (latency)
// and threads of a warp walk different rows (divergence). Nothing here is
// tuned yet; this first version aims at agreement with the twin.
//
// Numerics, chosen on purpose:
// * built with --fmad=false: a*b+c is never contracted, so every operation
//   rounds like the twin's separate torch ops;
// * lax.rsqrt is 1.0f / sqrtf (IEEE), not the approximate rsqrtf;
// * RNG to float is the TPU kernel's _u32_to_f32 (int32 reinterpret, then
//   +2^32 in f32), not __uint2float_rn;
// * sphere UVs use the polynomial atan2/asin of the TPU kernel;
// * min/max propagate NaN like jnp.minimum/torch.minimum (fminf would not),
//   so the slab test culls on a NaN exactly as the reference does;
// * f32 constants are written as exact hex literals.
//
// Counters: `rows` counts the trace rows THIS thread visited (closest walk,
// winner fetch, shadow walk). The TPU kernel counted per-packet row unions,
// so its values differ by design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 0x1.a36e2ep-14f;      // f32(1e-4)
constexpr float kTwoEps = 0x1.a36e2ep-13f;   // f32(2e-4)
constexpr float kBig = 0x1.c363ccp+127f;     // f32(3e38)
constexpr float kHalfPi = 0x1.921fb6p+0f;
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kTwoPi = 0x1.921fb6p+2f;
constexpr float kInv2Pi = 0x1.45f306p-3f;
constexpr float kInvPi = 0x1.45f306p-2f;
constexpr float kTiny = 0x1.4484c0p-100f;    // f32(1e-30)
constexpr float kQ99 = 0x1.fae148p-1f;       // f32(0.99)
constexpr float kInv2p32 = 0x1p-32f;

constexpr int kRowW = 32;
constexpr int kNState = 29;
constexpr int kAnaStride = 16;
constexpr int kEmStride = 28;
constexpr int kThreads = 128;

struct Scene {
  const float* rows;
  const float* consts;
  int total_rows, tbl_rows, ntab, analytic_mode;
  int na, ne, nd, ncb, ndl, nem;
  int ana_off, em_off, d_off, cb_off, dl_off, emi_off;
};

struct Path {
  float alive, bounce, ox, oy, oz, dx, dy, dz, tmin;
  float tr, tg, tb, er, eg, eb, Lr, Lg, Lb, wd;
  float depth, n1, n2, n3, rows, ar, ag, ab, segs, samp;
  uint32_t rng;
};

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fminf(a, b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fmaxf(a, b);
}
__device__ __forceinline__ float rsqrt_ieee(float x) { return 1.0f / sqrtf(x); }
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ uint32_t wang_hash(uint32_t s) {
  s = (s ^ 61u) ^ (s >> 16);
  s = s * 9u;
  s = s ^ (s >> 4);
  s = s * 0x27D4EB2Du;
  return s ^ (s >> 15);
}
__device__ __forceinline__ uint32_t xorshift(uint32_t s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}
// _u32_to_f32: bits as int32, converted, +2^32 when negative
__device__ __forceinline__ float u32_to_f32(uint32_t s) {
  int i = static_cast<int>(s);
  float f = static_cast<float>(i);
  return i < 0 ? f + 4294967296.0f : f;
}
__device__ __forceinline__ float randf(uint32_t& s) {
  s = xorshift(s);
  return u32_to_f32(s) * kInv2p32;
}

__device__ __forceinline__ float atan_poly(float z) {
  float t = z * z;
  float p = 0x1.555cbep-6f * t - 0x1.5cb46cp-4f;
  p = p * t + 0x1.70edc4p-3f;
  p = p * t - 0x1.523a08p-2f;
  p = p * t + 0x1.ffee70p-1f;
  return z * p;
}
__device__ __forceinline__ float atan2_poly(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  bool swap = ay > ax;
  float r = atan_poly((swap ? ax : ay) / (swap ? ay : ax));
  r = swap ? kHalfPi - r : r;
  r = x < 0.0f ? kPi - r : r;
  return y < 0.0f ? -r : r;
}
__device__ __forceinline__ float asin_poly(float x) {
  return atan2_poly(x, sqrtf(jmax(1.0f - x * x, 0.0f)));
}

// _bake_select: row m of a baked table, 0 where m is past its end
__device__ __forceinline__ float bake(const Scene& S, int off, int n, int ncols,
                                      float midx, int j) {
  int m = static_cast<int>(midx);
  if (midx == static_cast<float>(m) && m >= 0 && m < n)
    return S.consts[off + m * ncols + j];
  return 0.0f;
}

// ---------------------------------------------------------------- walk ----

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

// _prim_test on a classic 32-column row
__device__ __forceinline__ bool prim_test(const Scene& S, const float* r, float ox,
                                          float oy, float oz, float dx, float dy,
                                          float dz, float tmin, float best_t,
                                          float& pt, float& pu, float& pv) {
  float rx = ox - r[0], ry = oy - r[1], rz = oz - r[2];
  float kind = r[9];
  if (!S.analytic_mode && kind == 0.0f) {  // sphere row, radius in col 3
    float radius = r[3];
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
  float nx = r[29], ny = r[30], nz = r[31];
  float qx = ry * dz - rz * dy;
  float qy = rz * dx - rx * dz;
  float qz = rx * dy - ry * dx;
  float dd = 1.0f / (dx * nx + dy * ny + dz * nz);
  float u = -dd * (qx * r[6] + qy * r[7] + qz * r[8]);
  float v = dd * (qx * r[3] + qy * r[4] + qz * r[5]);
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

__device__ __forceinline__ int octant_base(const Scene& S, float dx, float dy,
                                           float dz) {
  if (S.ntab == 1) return 0;
  int oct = (dx > 0.0f) + 2 * (dy > 0.0f) + 4 * (dz > 0.0f);
  return oct * S.tbl_rows;
}

// The stackless walk. Closest hit (any_hit false) updates t/u/v/wrow;
// any-hit sets `hit` and stops at the first accept. Returns rows visited.
__device__ float walk(const Scene& S, float ox, float oy, float oz, float dx,
                      float dy, float dz, float tmin, float tmax, bool any_hit,
                      bool& hit, float& bt, float& bu, float& bv, int& wrow) {
  if (!(tmax >= 0.0f) || (any_hit && hit)) return 0.0f;
  float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  float tox = -ox * ix, toy = -oy * iy, toz = -oz * iz;
  int cur = octant_base(S, dx, dy, dz);
  int end = cur + S.tbl_rows;
  float nit = 0.0f;
  while (cur < end) {
    const float* r = S.rows + static_cast<size_t>(cur) * kRowW;
    nit = nit + 1.0f;
    int nexit = static_cast<int>(r[10]);
    float best_t = any_hit ? tmax : bt;
    if (r[9] < 0.0f) {  // interior row: slab test on its box
      float ax = r[0] * ix + tox, bx = r[3] * ix + tox;
      float ay = r[1] * iy + toy, by = r[4] * iy + toy;
      float az = r[2] * iz + toz, bz = r[5] * iz + toz;
      float t0 = jmax(jmax(jmin(ax, bx), jmin(ay, by)), jmin(az, bz));
      float t1 = jmin(jmin(jmax(ax, bx), jmax(ay, by)), jmax(az, bz));
      bool slab = (t0 < t1 + kEps) && (t0 < best_t) && (t1 > tmin);
      cur = slab ? cur + 1 : nexit;
      continue;
    }
    float pt, pu, pv;
    if (prim_test(S, r, ox, oy, oz, dx, dy, dz, tmin, best_t, pt, pu, pv) &&
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

struct Hit {
  bool found;
  float t, u, v, kind, tag, midx, nit;
  float pay[15];
};

// closest hit: analytic pretest, walk, winner resolve
__device__ void trace_closest(const Scene& S, const Path& p, Hit& h) {
  const int enc = S.total_rows;
  float bt = kBig, bu = 0.0f, bv = 0.0f;
  int wrow = enc + S.na;
  for (int k = 0; k < S.na; ++k) {
    const float* a = S.consts + S.ana_off + k * kAnaStride;
    float pt, pu, pv;
    if (analytic_test(a, p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, p.tmin, bt, pt,
                      pu, pv) &&
        pt < bt) {
      bt = pt;
      bu = pu;
      bv = pv;
      wrow = enc + k;
    }
  }
  bool unused = false;
  h.nit = walk(S, p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, p.tmin, kBig, false,
               unused, bt, bu, bv, wrow);
  h.t = bt;
  h.u = bu;
  h.v = bv;
  h.found = wrow < enc + S.na;
  h.kind = h.tag = h.midx = 0.0f;
  for (int j = 0; j < 15; ++j) h.pay[j] = 0.0f;
  if (wrow < enc) {
    const float* r = S.rows + static_cast<size_t>(wrow) * kRowW;
    h.kind = r[9];
    h.tag = r[12];
    h.midx = r[13];
    bool tri = h.kind == 2.0f;
    for (int j = 0; j < 15; ++j) h.pay[j] = tri ? r[14 + j] : (j < 9 ? r[j] : 0.0f);
    h.nit = h.nit + 1.0f;
  } else if (h.found) {
    const float* a = S.consts + S.ana_off + (wrow - enc) * kAnaStride;
    h.kind = a[0];
    h.tag = a[1];
    h.midx = a[2];
    for (int j = 0; j < 9; ++j) h.pay[j] = a[3 + j];
  }
}

// any hit in [tmin, tmax): returns whether occluded, adds rows visited
__device__ bool trace_any(const Scene& S, float ox, float oy, float oz, float dx,
                          float dy, float dz, float tmin, float tmax, float& nit) {
  bool hit = false;
  for (int k = 0; k < S.na && !hit; ++k) {
    const float* a = S.consts + S.ana_off + k * kAnaStride;
    float pt, pu, pv;
    hit = analytic_test(a, ox, oy, oz, dx, dy, dz, tmin, tmax, pt, pu, pv) &&
          pt < tmax;
  }
  float bt = 0.0f, bu = 0.0f, bv = 0.0f;
  int wrow = 0;
  nit = walk(S, ox, oy, oz, dx, dy, dz, tmin, tmax, true, hit, bt, bu, bv, wrow);
  return hit;
}

// ------------------------------------------------------------ shading ----

__device__ void camera_init(const Scene& S, float px, float py, uint32_t seed,
                            Path& p) {
  const float* c = S.consts;  // c.xyz, R (3x3 row-major), halfW, halfH, scale
  float lx = (px - c[12]) * c[14];
  float ly = -(py - c[13]) * c[14];
  float dxu = c[3] * lx + c[4] * ly - c[5];
  float dyu = c[6] * lx + c[7] * ly - c[8];
  float dzu = c[9] * lx + c[10] * ly - c[11];
  float inv_len = rsqrt_ieee(dxu * dxu + dyu * dyu + dzu * dzu);
  p.alive = 1.0f;
  p.bounce = 0.0f;
  p.segs = px * 0.0f;
  p.samp = px * 0.0f;
  p.ox = c[0];
  p.oy = c[1];
  p.oz = c[2];
  p.dx = dxu * inv_len;
  p.dy = dyu * inv_len;
  p.dz = dzu * inv_len;
  p.tmin = kEps;
  p.rng = wang_hash(seed);
  p.tr = p.tg = p.tb = 1.0f;
  p.er = p.eg = p.eb = 0.0f;
  p.Lr = p.Lg = p.Lb = 0.0f;
  p.wd = 1.0f;
  p.depth = p.n1 = p.n2 = p.n3 = 0.0f;
  p.rows = 0.0f;
  p.ar = p.ag = p.ab = 0.0f;
}

// One bounce of a live path (the body of _bounce_loop).
__device__ void bounce(const Scene& S, Path& p) {
  Hit h;
  trace_closest(S, p, h);
  if (!h.found) {
    p.alive = 0.0f;
    p.bounce = p.bounce + 1.0f;
    p.segs = p.segs + 1.0f;
    p.rows = p.rows + h.nit + 0.0f;
    return;
  }
  const float t = h.t, u = h.u, v = h.v, tag = h.tag, midx = h.midx;
  const float* pay = h.pay;
  float hx = p.ox + t * p.dx, hy = p.oy + t * p.dy, hz = p.oz + t * p.dz;

  // ---- shading frame (scalarized populate_intersection) ----
  float nx, ny, nz, fx, fy, fz, bx, by, bz, uvx, uvy;
  if (h.kind == 0.0f) {  // sphere: payload = (center, radius)
    float sr_inv = 1.0f / pay[3];
    nx = (hx - pay[0]) * sr_inv;
    ny = (hy - pay[1]) * sr_inv;
    nz = (hz - pay[2]) * sr_inv;
    float st_len = rsqrt_ieee(jmax(nz * nz + nx * nx, kTiny));
    fx = -nz * st_len;
    fy = 0.0f;
    fz = nx * st_len;
    bx = ny * fz;
    by = nz * fx - nx * fz;
    bz = -ny * fx;
    uvx = 0.5f + atan2_poly(nz, nx) * kInv2Pi;
    if (isnan(uvx)) uvx = 0.0f;
    uvy = 0.5f + asin_poly(jmin(jmax(ny, -1.0f), 1.0f)) * kInvPi;
  } else if (h.kind == 1.0f) {  // quad: payload = (edge1, edge2)
    float q1l = rsqrt_ieee(jmax(dot3(pay[3], pay[4], pay[5], pay[3], pay[4], pay[5]), kTiny));
    fx = pay[3] * q1l;
    fy = pay[4] * q1l;
    fz = pay[5] * q1l;
    float q2l = rsqrt_ieee(jmax(dot3(pay[6], pay[7], pay[8], pay[6], pay[7], pay[8]), kTiny));
    bx = pay[6] * q2l;
    by = pay[7] * q2l;
    bz = pay[8] * q2l;
    nx = fy * bz - fz * by;
    ny = fz * bx - fx * bz;
    nz = fx * by - fy * bx;
    uvx = u;
    uvy = v;
  } else {  // triangle: payload = (n0, n1, n2, uv0, uv1, uv2)
    float lam0 = 1.0f - u - v;
    float tnx = pay[0] * lam0 + pay[3] * u + pay[6] * v;
    float tny = pay[1] * lam0 + pay[4] * u + pay[7] * v;
    float tnz = pay[2] * lam0 + pay[5] * u + pay[8] * v;
    float tn_inv = rsqrt_ieee(jmax(dot3(tnx, tny, tnz, tnx, tny, tnz), kTiny));
    nx = tnx * tn_inv;
    ny = tny * tn_inv;
    nz = tnz * tn_inv;
    uvx = pay[9] * lam0 + pay[11] * u + pay[13] * v;
    uvy = pay[10] * lam0 + pay[12] * u + pay[14] * v;
    bool use_y = fabsf(nx) > fabsf(ny);
    float ttx = use_y ? -nz : 0.0f;
    float tty = use_y ? 0.0f : nz;
    float ttz = use_y ? nx : -ny;
    float tt_inv = rsqrt_ieee(jmax(dot3(ttx, tty, ttz, ttx, tty, ttz), kTiny));
    fx = ttx * tt_inv;
    fy = tty * tt_inv;
    fz = ttz * tt_inv;
    bx = ny * fz - nz * fy;
    by = nz * fx - nx * fz;
    bz = nx * fy - ny * fx;
  }

  if (p.bounce == 0.0f) {  // first-hit AOVs
    p.depth = t;
    p.n1 = nx;
    p.n2 = ny;
    p.n3 = nz;
  }

  // Beer-Lambert (render.glsl:111-112)
  float ddx = hx - p.ox, ddy = hy - p.oy, ddz = hz - p.oz;
  float dist = sqrtf(dot3(ddx, ddy, ddz, ddx, ddy, ddz));
  float tr = p.tr * expf(-p.er * dist);
  float tg = p.tg * expf(-p.eg * dist);
  float tb = p.tb * expf(-p.eb * dist);

  // emissive accumulation (render.glsl:114-116)
  if (tag == 4.0f && p.wd > 0.0f) {
    p.Lr = p.Lr + tr * bake(S, S.emi_off, S.nem, 3, midx, 0);
    p.Lg = p.Lg + tg * bake(S, S.emi_off, S.nem, 3, midx, 1);
    p.Lb = p.Lb + tb * bake(S, S.emi_off, S.nem, 3, midx, 2);
  }

  // ---- NEE (render.glsl:117-126, scene.glsl:54-89) ----
  const bool is_dif = tag == 0.0f, is_cb = tag == 1.0f;
  const bool difish = is_dif || is_cb;
  uint32_t st = p.rng;
  float u_pick = randf(st);
  float eu1 = randf(st);
  float eu2 = randf(st);
  uint32_t new_state = difish ? st : p.rng;

  // threshold pick: first e with u < cdf_e, fallback emitter 0
  int e = 0;
  for (int k = 1; k < S.ne; ++k) {
    const float* lo = S.consts + S.em_off + (k - 1) * kEmStride;
    const float* hi = lo + kEmStride;
    if (u_pick >= lo[2] && u_pick < hi[2]) e = k;
  }
  const float* em = S.consts + S.em_off + e * kEmStride;
  const float* g = em + 6;
  float epx, epy, epz, enx, eny, enz;
  if (em[0] == 2.0f) {  // triangle (shapes/triangle.glsl:81-102)
    float lu = (eu1 + eu2 > 1.0f) ? 1.0f - eu2 : eu1;
    float lv = eu2;
    float lw = 1.0f - lu - lv;
    epx = g[0] * lu + g[3] * lv + g[6] * lw;
    epy = g[1] * lu + g[4] * lv + g[7] * lw;
    epz = g[2] * lu + g[5] * lv + g[8] * lw;
    enx = g[9] * lu + g[12] * lv + g[15] * lw;
    eny = g[10] * lu + g[13] * lv + g[16] * lw;
    enz = g[11] * lu + g[14] * lv + g[17] * lw;
    float inv = rsqrt_ieee(jmax(dot3(enx, eny, enz, enx, eny, enz), kTiny));
    enx = enx * inv;
    eny = eny * inv;
    enz = enz * inv;
  } else if (em[0] == 1.0f) {  // quad (shapes/quad.glsl:34-45)
    enx = em[25];
    eny = em[26];
    enz = em[27];
    epx = g[0] + eu1 * g[3] + eu2 * g[6];
    epy = g[1] + eu1 * g[4] + eu2 * g[7];
    epz = g[2] + eu1 * g[5] + eu2 * g[8];
  } else {  // sphere (shapes/sphere.glsl:54-62)
    float z = 2.0f * eu1 - 1.0f;
    float theta = kTwoPi * eu2;
    float rxy = sqrtf(jmax(1.0f - z * z, 0.0f));
    enx = rxy * cosf(theta);
    eny = rxy * sinf(theta);
    enz = z;
    epx = g[0] + g[3] * enx;
    epy = g[1] + g[3] * eny;
    epz = g[2] + g[3] * enz;
  }
  float svx = epx - hx, svy = epy - hy, svz = epz - hz;
  float sdist = sqrtf(dot3(svx, svy, svz, svx, svy, svz));
  float sd_inv = 1.0f / sdist;
  float sdx = svx * sd_inv, sdy = svy * sd_inv, sdz = svz * sd_inv;
  float cos_theta = -dot3(sdx, sdy, sdz, enx, eny, enz);
  float pdf = em[1] * em[24] * sdist * sdist / cos_theta;
  float inv_pdf = cos_theta < 0.0f ? 0.0f : 1.0f / pdf;
  float impr = em[3] * inv_pdf, impg = em[4] * inv_pdf, impb = em[5] * inv_pdf;
  float imp_len = sqrtf(dot3(impr, impg, impb, impr, impg, impb));
  float cosw = dot3(sdx, sdy, sdz, nx, ny, nz);
  bool gate = difish && (imp_len > kEps) && (cosw > 0.0f);
  float nit_s = 0.0f;
  bool occluded = trace_any(S, hx, hy, hz, sdx, sdy, sdz, kTwoEps,
                            gate ? sdist - kEps : -1.0f, nit_s);

  // eval BSDF for NEE (material.glsl:18-30)
  float dcr = bake(S, S.d_off, S.nd, 3, midx, 0);
  float dcg = bake(S, S.d_off, S.nd, 3, midx, 1);
  float dcb = bake(S, S.d_off, S.nd, 3, midx, 2);
  float cbr = 0.0f, cbg = 0.0f, cbb = 0.0f;
  if (S.ncb > 0) {
    float c[8];
    for (int j = 0; j < 8; ++j) c[j] = bake(S, S.cb_off, S.ncb, 8, midx, j);
    float stx = 0.5f * uvx / c[3];
    float sty = 0.5f * uvy / c[7];
    stx = stx - floorf(stx);
    sty = sty - floorf(sty);
    bool flip = (stx < 0.5f) != (sty < 0.5f);
    cbr = flip ? c[4] : c[0];
    cbg = flip ? c[5] : c[1];
    cbb = flip ? c[6] : c[2];
  }
  if (p.bounce == 0.0f) {  // first-hit albedo AOV
    p.ar = is_dif ? dcr : (is_cb ? cbr : 0.0f);
    p.ag = is_dif ? dcg : (is_cb ? cbg : 0.0f);
    p.ab = is_dif ? dcb : (is_cb ? cbb : 0.0f);
  }
  if (gate && !occluded) {
    p.Lr = p.Lr + tr * (cosw * (is_dif ? dcr : cbr) * kInvPi) * impr;
    p.Lg = p.Lg + tg * (cosw * (is_dif ? dcg : cbg) * kInvPi) * impg;
    p.Lb = p.Lb + tb * (cosw * (is_dif ? dcb : cbb) * kInvPi) * impb;
  }

  // ---- BSDF sampling (material.glsl:33-91) ----
  uint32_t stA = new_state;
  float bu1 = randf(stA);
  uint32_t stB = stA;
  float bu2 = randf(stB);
  float wox, woy, woz, wr, wg, wb;
  bool tir = false;
  if (difish) {  // cosine hemisphere in the shading frame
    float rad = sqrtf(bu1);
    float th = kTwoPi * bu2;
    float hlx = rad * cosf(th), hly = rad * sinf(th);
    float hlz = sqrtf(jmax(1.0f - bu1, 0.0f));
    wox = fx * hlx + bx * hly + nx * hlz;
    woy = fy * hlx + by * hly + ny * hlz;
    woz = fz * hlx + bz * hly + nz * hlz;
    wr = is_dif ? dcr : cbr;
    wg = is_dif ? dcg : cbg;
    wb = is_dif ? dcb : cbb;
    new_state = stB;
  } else if (tag == 2.0f) {  // mirror
    float din = dot3(p.dx, p.dy, p.dz, nx, ny, nz);
    wox = p.dx - 2.0f * din * nx;
    woy = p.dy - 2.0f * din * ny;
    woz = p.dz - 2.0f * din * nz;
    wr = wg = wb = 1.0f;
  } else if (tag == 3.0f) {  // dielectric (material.glsl:50-87, incl. quirks)
    float ext_r = 0.0f, ext_g = 0.0f, ext_b = 0.0f, eta0 = 1.0f;
    if (S.ndl > 0) {
      ext_r = bake(S, S.dl_off, S.ndl, 4, midx, 0);
      ext_g = bake(S, S.dl_off, S.ndl, 4, midx, 1);
      ext_b = bake(S, S.dl_off, S.ndl, 4, midx, 2);
      eta0 = bake(S, S.dl_off, S.ndl, 4, midx, 3);
    }
    float din = dot3(p.dx, p.dy, p.dz, nx, ny, nz);
    float eta_inv0 = 1.0f / eta0;
    float cos_i0 = -din;
    bool flip = cos_i0 < 0.0f;
    float eta = flip ? eta_inv0 : eta0;
    // inside-hit etaInv = fl(1/fl(1/eta)), the reference's double reciprocal
    float eta_inv = flip ? 1.0f / eta_inv0 : eta_inv0;
    float nnx = flip ? -nx : nx, nny = flip ? -ny : ny, nnz = flip ? -nz : nz;
    float cos_i = flip ? -cos_i0 : cos_i0;
    float kk = 1.0f - eta_inv * eta_inv * (1.0f - cos_i * cos_i);
    tir = kk <= 0.0f;
    float cos_o = sqrtf(jmax(kk, 0.0f));
    float rho_par = (eta * cos_i - cos_o) / (eta * cos_i + cos_o);
    float rho_orth = (cos_i - eta * cos_o) / (cos_i + eta * cos_o);
    float f_r = 0.5f * (rho_par * rho_par + rho_orth * rho_orth);
    bool choose_reflect = bu1 < f_r;
    float dinn = dot3(p.dx, p.dy, p.dz, nnx, nny, nnz);
    if (tir || choose_reflect) {
      wox = p.dx - 2.0f * dinn * nnx;
      woy = p.dy - 2.0f * dinn * nny;
      woz = p.dz - 2.0f * dinn * nnz;
    } else {
      wox = eta_inv * (p.dx - dinn * nnx) - cos_o * nnx;
      woy = eta_inv * (p.dy - dinn * nny) - cos_o * nny;
      woz = eta_inv * (p.dz - dinn * nnz) - cos_o * nnz;
    }
    bool refracted = !tir && !choose_reflect;
    if (refracted != (cos_i0 > 0.0f)) {  // the inverted inside flag
      p.er = ext_r;
      p.eg = ext_g;
      p.eb = ext_b;
    }
    wr = wg = wb = 1.0f;
    if (!tir) new_state = stA;
  } else {  // emissive: continue straight with zero throughput
    wox = p.dx;
    woy = p.dy;
    woz = p.dz;
    wr = wg = wb = 0.0f;
  }
  tr = tr * wr;
  tg = tg * wg;
  tb = tb * wb;
  p.ox = hx;
  p.oy = hy;
  p.oz = hz;
  p.dx = wox;
  p.dy = woy;
  p.dz = woz;
  p.tmin = kTwoEps;
  p.wd = difish ? 0.0f : 1.0f;

  // Russian roulette (render.glsl:137-144)
  bool kill = false;
  if (p.bounce > 3.0f) {
    float u_rr = randf(new_state);
    float q = jmin(kQ99, jmax(tr, jmax(tg, tb)));
    kill = u_rr > q;
    if (!kill) {
      tr = tr / q;
      tg = tg / q;
      tb = tb / q;
    }
  }
  p.rng = new_state;
  p.tr = tr;
  p.tg = tg;
  p.tb = tb;
  p.alive = kill ? 0.0f : 1.0f;
  p.bounce = p.bounce + 1.0f;
  p.segs = p.segs + 1.0f;
  p.rows = p.rows + h.nit + nit_s;
}

__device__ void bounce_loop(const Scene& S, Path& p, float cap) {
  while (p.alive > 0.0f && p.bounce < cap) bounce(S, p);
}

// the 29 f32 channels in _STATE_CH order (ops/megakernel.py)
#define STATE_FIELDS(X)                                                        \
  X(0, alive) X(1, bounce) X(2, ox) X(3, oy) X(4, oz) X(5, dx) X(6, dy)        \
  X(7, dz) X(8, tmin) X(9, tr) X(10, tg) X(11, tb) X(12, er) X(13, eg)         \
  X(14, eb) X(15, Lr) X(16, Lg) X(17, Lb) X(18, wd) X(19, depth) X(20, n1)     \
  X(21, n2) X(22, n3) X(23, rows) X(24, ar) X(25, ag) X(26, ab) X(27, segs)    \
  X(28, samp)
static_assert(kNState == 29, "state channel count");

__device__ __forceinline__ void read_state(const float* st, const uint32_t* rng,
                                           int i, int n, Path& p) {
#define READ_FIELD(c, f) p.f = st[static_cast<size_t>(c) * n + i];
  STATE_FIELDS(READ_FIELD)
#undef READ_FIELD
  p.rng = rng[i];
}

__device__ __forceinline__ void write_state(const Path& p, float* st,
                                            uint32_t* rng, int i, int n) {
#define WRITE_FIELD(c, f) st[static_cast<size_t>(c) * n + i] = p.f;
  STATE_FIELDS(WRITE_FIELD)
#undef WRITE_FIELD
  rng[i] = p.rng;
}

__global__ void __launch_bounds__(kThreads)
    mk_start_kernel(Scene S, const float* px, const float* py,
                    const uint32_t* seeds, int n, float cap, float* st_out,
                    uint32_t* rng_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Path p;
  camera_init(S, px[i], py[i], seeds[i], p);
  bounce_loop(S, p, cap);
  write_state(p, st_out, rng_out, i, n);
}

__global__ void __launch_bounds__(kThreads)
    mk_resume_kernel(Scene S, const float* st_in, const uint32_t* rng_in, int n,
                     float cap, float* st_out, uint32_t* rng_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Path p;
  read_state(st_in, rng_in, i, n, p);
  bounce_loop(S, p, cap);
  write_state(p, st_out, rng_out, i, n);
}

Scene make_scene(const float* rows, const float* consts, int total_rows,
                 int tbl_rows, int ntab, int analytic_mode, int na, int ne,
                 int nd, int ncb, int ndl, int nem) {
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
  return S;
}

}  // namespace

#define SCENE_ARGS                                                             \
  const float *rows, const float *consts, int total_rows, int tbl_rows,        \
      int ntab, int analytic_mode, int na, int ne, int nd, int ncb, int ndl,   \
      int nem
#define SCENE_CALL                                                             \
  make_scene(rows, consts, total_rows, tbl_rows, ntab, analytic_mode, na, ne,  \
             nd, ncb, ndl, nem)

extern "C" int mk_start(SCENE_ARGS, const float* px, const float* py,
                        const uint32_t* seeds, int n, int cap, float* st_out,
                        uint32_t* rng_out, void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  mk_start_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      SCENE_CALL, px, py, seeds, n, static_cast<float>(cap), st_out, rng_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mk_resume(SCENE_ARGS, const float* st_in, const uint32_t* rng_in,
                         int n, int cap, float* st_out, uint32_t* rng_out,
                         void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  mk_resume_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      SCENE_CALL, st_in, rng_in, n, static_cast<float>(cap), st_out, rng_out);
  return static_cast<int>(cudaGetLastError());
}

// Path-tracing megakernel for Hopper (sm_90a): the launches of the phased
// wavefront driver, chained or not, and the single-launch render.
//
// Replaces, in hijiki_tpu/ops/pallas_megakernel.py:
//   _megakernel_start          -> mk_start          (K1)
//   _megakernel_resume         -> mk_resume         (K2)
//   _megakernel_start_chained  -> mk_start_chained  (K4, note below)
//   _megakernel/_megakernel_body (render_tiles) -> mk_tiles (K5)
// and, with lane_sort=True (K7, _lane_sort with pallas_sort.py's network
// inside the bounce loop), the lane-sorted K1/K2/K5:
//   mk_start_sorted, mk_resume_sorted, mk_tiles_sorted (note below).
// All share bounce_loop(), the port of _bounce_loop with _camera_init,
// _analytic_pretest, the trace-row walk (both in walk.cuh, which the walk
// probe of probe_walk.cu shares), _resolve_winners, NEE, the BSDFs and
// Russian roulette. The plain PyTorch twin of every line below is
// hijiki_tpu_torch/ops/megakernel.py.
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

#include "sort.cuh"
#include "walk.cuh"

namespace {

constexpr float kTwoEps = 0x1.a36e2ep-13f;   // f32(2e-4)
constexpr float kHalfPi = 0x1.921fb6p+0f;
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kTwoPi = 0x1.921fb6p+2f;
constexpr float kInv2Pi = 0x1.45f306p-3f;
constexpr float kInvPi = 0x1.45f306p-2f;
constexpr float kTiny = 0x1.4484c0p-100f;    // f32(1e-30)
constexpr float kQ99 = 0x1.fae148p-1f;       // f32(0.99)
constexpr float kInv2p32 = 0x1p-32f;

constexpr int kNState = 29;
constexpr int kChainOut = 12;  // CHAIN_OUT_CH
constexpr int kTileOut = 7;    // render_tiles' result channels
constexpr int kThreads = 128;

struct Path {
  float alive, bounce, ox, oy, oz, dx, dy, dz, tmin;
  float tr, tg, tb, er, eg, eb, Lr, Lg, Lb, wd;
  float depth, n1, n2, n3, rows, ar, ag, ab, segs, samp;
  uint32_t rng;
};

__device__ __forceinline__ float rsqrt_ieee(float x) { return 1.0f / sqrtf(x); }
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
// (analytic_test, prim_test, octant_base, walk: walk.cuh)

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
  analytic_pretest(S, p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, p.tmin, bt, bu, bv, wrow);
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

// ------------------------------------------------------ lane-sorted K1/K2/K5 --
//
// The mega driver's --sort-lanes (JAX: lane_sort=True, _lane_sort at
// pallas_megakernel.py:2003 with pallas_sort.py::sort_tile_by_key). A block
// of kSortTile threads holds kSortTile paths and runs the bounce loop in
// lockstep: while any of its paths is going, the going threads run one
// bounce, every thread computes its path's key (dead last, then the
// direction octant, then the origin's cell of a 4x4x4 grid over the scene
// box), the block sorts the keys (sort.cuh) and each thread takes over the
// path of its source lane through shared memory. After the loop each path
// goes back to the thread of its path id (a direct inverse: path ids are
// unique, so this equals JAX's sort by pid) and is written out.
//
// The sort permutes whole paths and each thread walks alone, so every
// output equals the unsorted kernels' bit for bit; what the sort changes
// is which paths share a warp: paths of one octant and cell walk similar
// rows, and dead paths gather at the end of the tile, so whole warps idle
// instead of a few lanes in every warp.
//
// The tile: kSortTile = 256 lanes (a block of 256 threads). The TPU sorted
// its 1024-lane tile; any tile gives the same outputs (a pure permutation),
// and a 1024-thread block would cap the megakernel at 64 registers a thread
// (65,536 per SM). The exchange buffer holds the tile's 29 state words, RNG
// and path id (31 words a path, 31 KB at 256 lanes) in dynamic shared
// memory, with the sort's own 4 KB beside it: 35 KB, under the 48 KB a
// launch gets without opting in (larger tiles opt in, see launch_paths).
// ops/megakernel.py::SORT_TILE must equal kSortTile.
//
// Every thread reaches every barrier: a thread past the last path (i >= n)
// carries a dead path, takes part in the sorts and writes nothing.
//
// The outputs cannot show the sort (they equal the unsorted kernels'), so
// the sorted launches take an optional `order` record: the path id at each
// lane after the block's last sort and that path's key, which the plain
// version reproduces bit for bit (ops/megakernel.py::_bounce_loop). The
// render path passes null.

constexpr int kSortTile = 256;
constexpr int kSortWords = kNState + 2;  // the state, the RNG, the path id
constexpr int kDeadKey = 1 << 20;

struct SortShared {
  hijiki_sort::Scratch<kSortTile> sort;
  uint32_t path[kSortWords][kSortTile];
};

// clip(int32(x), 0, 3) as XLA computes it (saturating, NaN -> 0), clamped
// in float before the cast
__device__ __forceinline__ int grid_cell(float x) {
  return isnan(x) ? 0 : static_cast<int>(jmin(jmax(x, 0.0f), 3.0f));
}

// _lane_sort's key; the box min and scale are f32 bakes of the host's doubles
__device__ __forceinline__ int lane_key(const Scene& S, const Path& p) {
  if (!(p.alive > 0.0f)) return kDeadKey;
  const float* c = S.consts + S.sort_off;
  const int qx = grid_cell((p.ox - c[0]) * c[3]);
  const int qy = grid_cell((p.oy - c[1]) * c[4]);
  const int qz = grid_cell((p.oz - c[2]) * c[5]);
  const int oct = (p.dx > 0.0f) + 2 * (p.dy > 0.0f) + 4 * (p.dz > 0.0f);
  return oct + 8 * (qx + 4 * (qy + 4 * qz));
}

// every thread writes its path (and id) to slot `dst` and takes the path
// in slot `src`
__device__ __forceinline__ void move_path(Path& p, int& pid, int dst, int src,
                                          SortShared& sh) {
#define PUT_FIELD(c, f) sh.path[c][dst] = __float_as_uint(p.f);
  STATE_FIELDS(PUT_FIELD)
#undef PUT_FIELD
  sh.path[kNState][dst] = p.rng;
  sh.path[kNState + 1][dst] = static_cast<uint32_t>(pid);
  __syncthreads();
#define GET_FIELD(c, f) p.f = __uint_as_float(sh.path[c][src]);
  STATE_FIELDS(GET_FIELD)
#undef GET_FIELD
  p.rng = sh.path[kNState][src];
  pid = static_cast<int>(sh.path[kNState + 1][src]);
  __syncthreads();
}

// thread i of the block holds path i of the tile; `order` (nullable): the
// record of the last sort, at order[i] and order[n + i]
__device__ void bounce_loop_sorted(const Scene& S, Path& p, float cap, int i,
                                   int n, int* order) {
  extern __shared__ __align__(16) unsigned char smem[];
  SortShared& sh = *reinterpret_cast<SortShared*>(smem);
  const int lane = threadIdx.x;
  int pid = lane;
  while (__syncthreads_or(p.alive > 0.0f && p.bounce < cap)) {
    if (p.alive > 0.0f && p.bounce < cap) bounce(S, p);
    int key = lane_key(S, p);
    const int src = hijiki_sort::block_sort<kSortTile>(key, sh.sort);
    move_path(p, pid, lane, src, sh);
  }
  if (order != nullptr && i < n) {
    order[i] = blockIdx.x * kSortTile + pid;
    order[n + i] = lane_key(S, p);
  }
  move_path(p, pid, pid, lane, sh);  // back to the path's own lane
}

// a path's bounces to `cap`: alone, or in the block's sorted lockstep
template <bool kSort>
__device__ __forceinline__ void run_path(const Scene& S, Path& p, float cap,
                                         int i, int n, int* order) {
  if constexpr (kSort)
    bounce_loop_sorted(S, p, cap, i, n, order);
  else
    bounce_loop(S, p, cap);
}

// K1 and K2, and with kSort their lane-sorted variants (mk_start_sorted,
// mk_resume_sorted). A sorted block's threads past the last path carry a
// dead path to the end.
template <bool kSort>
__global__ void __launch_bounds__(kSort ? kSortTile : kThreads)
    mk_start_kernel(Scene S, const float* px, const float* py,
                    const uint32_t* seeds, int n, float cap, float* st_out,
                    uint32_t* rng_out, int* order) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (!kSort && i >= n) return;
  Path p{};
  if (i < n) camera_init(S, px[i], py[i], seeds[i], p);
  run_path<kSort>(S, p, cap, i, n, order);
  if (i < n) write_state(p, st_out, rng_out, i, n);
}

template <bool kSort>
__global__ void __launch_bounds__(kSort ? kSortTile : kThreads)
    mk_resume_kernel(Scene S, const float* st_in, const uint32_t* rng_in, int n,
                     float cap, float* st_out, uint32_t* rng_out, int* order) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (!kSort && i >= n) return;
  Path p{};
  if (i < n) read_state(st_in, rng_in, i, n, p);
  run_path<kSort>(S, p, cap, i, n, order);
  if (i < n) write_state(p, st_out, rng_out, i, n);
}

// K4, the chained camera launch (_megakernel_start_chained with the chain
// block of _bounce_loop, pallas_megakernel.py:2618-2681).
//
// Each thread traces the `nsamp` sweep samples of its pixel one after the
// other. A sample's path bounces until it dies or reaches `cap`; then it is
//   * parked, if still alive: its full state goes to slot samp*n + lane of
//     the (29, nsamp*n) pool and of the (nsamp*n,) RNG pool, and the
//     compaction phases resume it later (no sample is dropped), or
//   * flushed, if dead: its 12 CHAIN_OUT_CH values (Lr,Lg,Lb, n1,n2,n3,
//     depth, segs, rows, ar,ag,ab) go to column samp*n + lane of the
//     (12, nsamp*n) buffer, and its final RNG to the RNG pool;
// and the thread respawns on the next sample: a fresh camera ray from
// pxs/pys/seeds[samp+1][lane] (camera_init), samp = samp + 1.
// The TPU kernel selected a sample's slot with a where-chain over S and
// wrote every slot masked; a thread indexes its slot directly. Both
// outputs are in the (C, nsamp*n) layout that the compaction phases
// consume, so no transpose follows. The wrapper zeroes the pool and the
// flush buffer: an empty pool slot must read alive = 0, and a parked
// sample's flush column must read 0 until its resume commits it.
//
// What bounds it: as K1, the dependent loads of the walk and the
// divergence of a warp's threads. Respawn hides part of the divergence: a
// thread whose path dies early starts its next sample instead of idling
// until the warp's longest path ends, so a warp runs for the longest SUM
// of nsamp capped samples, not for nsamp times the longest path.
//
// The RNG pool also receives flushed samples' final states (the TPU kernel
// leaves those slots 0), so the chained driver returns per sweep the same
// RNG states as separate sweeps.
__global__ void __launch_bounds__(kThreads)
    mk_start_chained_kernel(Scene S, const float* pxs, const float* pys,
                            const uint32_t* seeds, int n, int nsamp, float cap,
                            float* pool, uint32_t* pool_rng, float* chain_out) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int sn = nsamp * n;
  Path p;
  camera_init(S, pxs[lane], pys[lane], seeds[lane], p);
  for (int s = 0;;) {
    bounce_loop(S, p, cap);
    const int slot = s * n + lane;
    if (p.alive > 0.0f) {  // park
      write_state(p, pool, pool_rng, slot, sn);
    } else {  // flush
      const float vals[kChainOut] = {p.Lr, p.Lg, p.Lb, p.n1, p.n2, p.n3,
                                     p.depth, p.segs, p.rows, p.ar, p.ag, p.ab};
#pragma unroll
      for (int c = 0; c < kChainOut; ++c)
        chain_out[static_cast<size_t>(c) * sn + slot] = vals[c];
      pool_rng[slot] = p.rng;
    }
    if (++s == nsamp) break;
    const int next = s * n + lane;  // respawn on the pixel's next sample
    camera_init(S, pxs[next], pys[next], seeds[next], p);
    p.samp = static_cast<float>(s);
  }
}

// K5, the single-launch render (_megakernel/_megakernel_body): camera ray
// and bounces to `cap`, then only the 7 result channels (Lr,Lg,Lb,
// n1,n2,n3, depth) and the RNG; no 29-channel state. kSort:
// mk_tiles_sorted.
template <bool kSort>
__global__ void __launch_bounds__(kSort ? kSortTile : kThreads)
    mk_tiles_kernel(Scene S, const float* px, const float* py,
                    const uint32_t* seeds, int n, float cap, float* out,
                    uint32_t* rng_out, int* order) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (!kSort && i >= n) return;
  Path p{};
  if (i < n) camera_init(S, px[i], py[i], seeds[i], p);
  run_path<kSort>(S, p, cap, i, n, order);
  if (i >= n) return;
  const float vals[kTileOut] = {p.Lr, p.Lg, p.Lb, p.n1, p.n2, p.n3, p.depth};
#pragma unroll
  for (int c = 0; c < kTileOut; ++c) out[static_cast<size_t>(c) * n + i] = vals[c];
  rng_out[i] = p.rng;
}

// the launch of K1/K2/K5: blocks of kThreads paths, or of kSortTile with
// the exchange buffer in dynamic shared memory for the sorted kernels
// (opting in past 48 KB, which only tiles of 512 lanes and more need)
template <bool kSort, typename... Params, typename... Args>
int launch_paths(void (*kernel)(Params...), int n, void* stream, Args... args) {
  constexpr int block = kSort ? kSortTile : kThreads;
  constexpr size_t smem = kSort ? sizeof(SortShared) : 0;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<(n + block - 1) / block, block, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1/K2/K5 and their sorted variants; `order` (sorted only) may be null
#define START_ARGS                                                             \
  SCENE_ARGS, const float *px, const float *py, const uint32_t *seeds, int n,  \
      int cap
#define RESUME_ARGS                                                            \
  SCENE_ARGS, const float *st_in, const uint32_t *rng_in, int n, int cap

extern "C" int mk_start(START_ARGS, float* st_out, uint32_t* rng_out,
                        void* stream) {
  return launch_paths<false>(mk_start_kernel<false>, n, stream, SCENE_CALL, px,
                             py, seeds, n, static_cast<float>(cap), st_out,
                             rng_out, nullptr);
}

extern "C" int mk_start_sorted(START_ARGS, float* st_out, uint32_t* rng_out,
                               int* order, void* stream) {
  return launch_paths<true>(mk_start_kernel<true>, n, stream, SCENE_CALL, px,
                            py, seeds, n, static_cast<float>(cap), st_out,
                            rng_out, order);
}

extern "C" int mk_resume(RESUME_ARGS, float* st_out, uint32_t* rng_out,
                         void* stream) {
  return launch_paths<false>(mk_resume_kernel<false>, n, stream, SCENE_CALL,
                             st_in, rng_in, n, static_cast<float>(cap), st_out,
                             rng_out, nullptr);
}

extern "C" int mk_resume_sorted(RESUME_ARGS, float* st_out, uint32_t* rng_out,
                                int* order, void* stream) {
  return launch_paths<true>(mk_resume_kernel<true>, n, stream, SCENE_CALL,
                            st_in, rng_in, n, static_cast<float>(cap), st_out,
                            rng_out, order);
}

extern "C" int mk_tiles(START_ARGS, float* out, uint32_t* rng_out,
                        void* stream) {
  return launch_paths<false>(mk_tiles_kernel<false>, n, stream, SCENE_CALL, px,
                             py, seeds, n, static_cast<float>(cap), out,
                             rng_out, nullptr);
}

extern "C" int mk_tiles_sorted(START_ARGS, float* out, uint32_t* rng_out,
                               int* order, void* stream) {
  return launch_paths<true>(mk_tiles_kernel<true>, n, stream, SCENE_CALL, px,
                            py, seeds, n, static_cast<float>(cap), out, rng_out,
                            order);
}

extern "C" int mk_start_chained(SCENE_ARGS, const float* pxs, const float* pys,
                                const uint32_t* seeds, int n, int nsamp, int cap,
                                float* pool, uint32_t* pool_rng, float* chain_out,
                                void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  mk_start_chained_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      SCENE_CALL, pxs, pys, seeds, n, nsamp, static_cast<float>(cap), pool,
      pool_rng, chain_out);
  return static_cast<int>(cudaGetLastError());
}

// Path-tracing megakernel for Hopper (sm_90a): the launches of the phased
// wavefront driver, chained or not, and the single-launch render.
//
// Replaces, in hijiki_tpu/ops/pallas_megakernel.py:
//   _megakernel_start          -> mk_start          (K1, persistent: note below)
//   _megakernel_resume         -> mk_resume         (K2; its tail mode
//                                 mk_resume_tail, a warp a path: note at K2)
//   _megakernel_start_chained  -> mk_start_chained  (K4, persistent: note below)
//   _megakernel/_megakernel_body (render_tiles) -> mk_tiles (K5, persistent)
// and, with lane_sort=True (K7, _lane_sort with pallas_sort.py's network
// inside the bounce loop), the lane-sorted K1/K2/K5:
//   mk_start_sorted, mk_resume_sorted, mk_tiles_sorted (note below).
// All share bounce(), the port of _bounce_loop's body, with _camera_init,
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
// signs. K2 traces a whole path per thread (in its tail mode a whole path
// per warp, its lane 0 running it); K4, K1 and K5 are persistent
// and bounce-granular (a thread whose path stopped takes the next slot one
// bounce later; note below); the sorted kernels run a block's paths in
// lockstep; render_waves compacts the survivors between phases.
//
// What bounds it: the walk is a chain of dependent global loads (latency)
// and threads of a warp walk different rows (divergence); the walk's row
// step is in walk.cuh.
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
//
// The scene's trace-row format (scene/compile.py, _prim_test's packed and
// the shadow_ref branch of _bounce_loop): the classic 32-column rows, or
// a packed table of 1, 3, 4 or 12 triangles a row with its payload section
// (walk.cuh::walk_packed; trace_closest resolves a packed winner from its
// payload row), and, with classic rows, the dedicated PACKED3 any-hit
// table that shadow rays walk instead of the main one (trace_any<kSh>).
// Each kernel is a template on the format, <kFmt, kSh>, whose default
// <0, false> is the classic rows, and each C entry launches the
// instantiation of the scene's format (FMT_KERNEL). The
// shadow-visibility boxes are read at run time (nbox of them, 0 when the
// launch reads none): a lane whose NEE origin lies in a box skips its
// shadow walk. None of these changes an output but the rows counter.
//
// The shadow-ray occlusion cache (JAX's shadow_cache: _anyhit_pretest and
// the srow carry of _bounce_loop; arXiv 1910.01304's ray-path prediction),
// a third template flag kCache of every kernel (FMT_KERNEL: the launch's
// cache word picks the instantiation; the cache-off code is the one the
// kernels had). A path carries a predicted occluder row (-1: none), in a
// register and, where the bounce stashes, in the stash or the sorted
// exchange column, never in the 29-word state: it starts at -1 with every
// path (a camera start, a respawned slot, a resumed path) and moves with
// its path through the lane sort. Before a shadow walk that NEE gates in and
// no box skips, the prediction's row is tested with the walk's own accept
// (prim_test / packed_test with best_t = tmax, strict t < tmax); a hit
// answers the any-hit query and the walk is skipped, else the walk runs as
// without the cache. After the bounce a gated path predicts the row that
// answered (the verified row, or the row where the walk accepted) and -1
// where an analytic prim, a box or nothing answered; an ungated bounce keeps
// its prediction. The occluded flag is the cache-off one, so every output
// but `rows` (which counts the tested row) is the cache-off kernel's, bit for
// bit. Unlike JAX, an analytic occluder is found first and no prediction is
// tested then, and a lane's prediction never outlives its path.
//
// The skip-all probe (JAX's render_waves(shadow_skip_all=True), a run-time
// scene word): every gated lane takes visibility 1 and walks nothing, a
// biased image that prices any shadow-walk shortcut at its upper bound.

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

// the 29 f32 channels in _STATE_CH order (ops/megakernel.py)
#define STATE_FIELDS(X)                                                        \
  X(0, alive) X(1, bounce) X(2, ox) X(3, oy) X(4, oz) X(5, dx) X(6, dy)        \
  X(7, dz) X(8, tmin) X(9, tr) X(10, tg) X(11, tb) X(12, er) X(13, eg)         \
  X(14, eb) X(15, Lr) X(16, Lg) X(17, Lb) X(18, wd) X(19, depth) X(20, n1)     \
  X(21, n2) X(22, n3) X(23, rows) X(24, ar) X(25, ag) X(26, ab) X(27, segs)    \
  X(28, samp)
static_assert(kNState == 29, "state channel count");


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

// closest hit: analytic pretest, walk, winner resolve. kFmt: the trace-row
// format (0 classic; 1, 3, 4, 12 packed: the winner is a payload slot, its
// row at ntab * tbl_rows + slot (SLIM: two rows a slot) holds kind, tag,
// midx and the 15 payload floats in columns 0-17, and winners encode from
// n_pay)
template <int kFmt = 0>
__device__ void trace_closest(const Scene& S, const Path& p, Hit& h) {
  const int enc = kFmt == 0 ? S.total_rows : S.n_pay;
  float bt = kBig, bu = 0.0f, bv = 0.0f;
  int wrow = enc + S.na;
  analytic_pretest(S, enc, p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, p.tmin, bt, bu, bv,
                   wrow);
  bool unused = false;
  if constexpr (kFmt == 0) {
    h.nit = walk(S, p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, p.tmin, kBig, false,
                 unused, bt, bu, bv, wrow);
  } else {
    const int base = octant_base(S, p.dx, p.dy, p.dz);
    h.nit = walk_packed<kFmt>(S.rows, base, base + S.tbl_rows, p.ox, p.oy, p.oz,
                              p.dx, p.dy, p.dz, p.tmin, kBig, false, unused, bt,
                              bu, bv, wrow);
  }
  h.t = bt;
  h.u = bu;
  h.v = bv;
  h.found = wrow < enc + S.na;
  h.kind = h.tag = h.midx = 0.0f;
  for (int j = 0; j < 15; ++j) h.pay[j] = 0.0f;
  if (wrow < enc) {
    if constexpr (kFmt == 0) {
      const float* r = S.rows + static_cast<size_t>(wrow) * kRowW;
      h.kind = r[9];
      h.tag = r[12];
      h.midx = r[13];
      bool tri = h.kind == 2.0f;
      for (int j = 0; j < 15; ++j) h.pay[j] = tri ? r[14 + j] : (j < 9 ? r[j] : 0.0f);
    } else {
      constexpr int kW = packed_width<kFmt>();
      const size_t at = static_cast<size_t>(S.ntab) * S.tbl_rows +
                        static_cast<size_t>(wrow) * (kFmt == 1 ? 2 : 1);
      const float* r = S.rows + at * kW;
      h.kind = r[0];
      h.tag = r[1];
      h.midx = r[2];
      // SLIM: payload 0-11 in the slot's first row, 12-14 in its second
      for (int j = 0; j < 15; ++j)
        h.pay[j] = (kFmt == 1 && j >= 12) ? r[kW + j - 12] : r[3 + j];
    }
    h.nit = h.nit + 1.0f;
  } else if (h.found) {
    const float* a = S.consts + S.ana_off + (wrow - enc) * kAnaStride;
    h.kind = a[0];
    h.tag = a[1];
    h.midx = a[2];
    for (int j = 0; j < 9; ++j) h.pay[j] = a[3 + j];
  }
}

// where a packed any-hit walk stops at the first occluding prim
// (walk_packed's kStop, packed_test's any-hit accept): the occlusion
// cache's instantiations but PACKED12's. Elsewhere the any-hit walks run
// the tournament and compare its t: there the early accept read slower
// (PACKED12) or flipped K2's registers into spills past its record
// (PERF.md §6)
template <int kFmt, bool kCache>
constexpr bool kAnyStop = kCache && kFmt != 12;

// the occlusion cache's pretest: whether row `pred` of the main table
// occludes [tmin, tmax), by the walk's own accept (a packed row: any of its
// prims, the tournament's min t being below tmax, or kAnyStop's first)
template <int kFmt>
__device__ __forceinline__ bool row_occludes(const Scene& S, int pred, float ox,
                                             float oy, float oz, float dx, float dy,
                                             float dz, float tmin, float tmax) {
  constexpr int kW = kFmt == 0 ? kRowW : packed_width<kFmt>();
  const float* r = S.rows + static_cast<size_t>(pred) * kW;
  const float4 c0 = row4(r, 0), c1 = row4(r, 4), c2 = row4(r, 8);
  float pt, pu, pv;
  if constexpr (kFmt == 0) {
    return prim_test(S, r, c0, c1, c2, ox, oy, oz, dx, dy, dz, tmin, tmax, pt, pu, pv) &&
           pt < tmax;
  } else {
    float slot;
    if constexpr (kAnyStop<kFmt, true>)
      return packed_test<kFmt, true>(r, c0, c1, c2, ox, oy, oz, dx, dy, dz, tmin, tmax, pt,
                                     pu, pv, slot);
    else
      return packed_test<kFmt>(r, c0, c1, c2, ox, oy, oz, dx, dy, dz, tmin, tmax, pt, pu,
                               pv, slot) &&
             pt < tmax;
  }
}

// any hit in [tmin, tmax): returns whether occluded, adds rows visited.
// kSh: walk the dedicated PACKED3 shadow table (one table, no payload)
// instead of the main one. kCache: first test the predicted row `pred`
// (-1: none; counted as a row visited) and report in `orow` the row that
// answered: the verified one, or where the walk accepted (-1: an analytic
// prim, or no occluder)
template <int kFmt = 0, bool kSh = false, bool kCache = false>
__device__ bool trace_any(const Scene& S, float ox, float oy, float oz, float dx,
                          float dy, float dz, float tmin, float tmax, float& nit,
                          int pred = -1, int* orow = nullptr) {
  static_assert(!(kSh && kCache), "the cache predicts rows of the main table");
  bool hit = false;
  for (int k = 0; k < S.na && !hit; ++k) {
    const float* a = S.consts + S.ana_off + k * kAnaStride;
    float pt, pu, pv;
    hit = analytic_test(a, ox, oy, oz, dx, dy, dz, tmin, tmax, pt, pu, pv) &&
          pt < tmax;
  }
  float bt = 0.0f, bu = 0.0f, bv = 0.0f;
  int wrow = -1;
  float pre = 0.0f;
  if constexpr (kCache) {
    if (!hit && pred >= 0 && pred < S.total_rows) {
      pre = 1.0f;
      hit = row_occludes<kFmt>(S, pred, ox, oy, oz, dx, dy, dz, tmin, tmax);
      if (hit) wrow = pred;
    }
  }
  if constexpr (kSh) {
    nit = walk_packed<3>(S.shadow_rows, 0, S.shadow_n, ox, oy, oz, dx, dy, dz, tmin,
                         tmax, true, hit, bt, bu, bv, wrow);
  } else if constexpr (kFmt == 0) {
    nit = walk(S, ox, oy, oz, dx, dy, dz, tmin, tmax, true, hit, bt, bu, bv, wrow);
  } else {
    const int base = octant_base(S, dx, dy, dz);
    nit = walk_packed<kFmt, true, 1, kAnyStop<kFmt, kCache>>(
        S.rows, base, base + S.tbl_rows, ox, oy, oz, dx, dy, dz, tmin, tmax, true, hit, bt,
        bu, bv, wrow);
  }
  if constexpr (kCache) {
    nit = pre + nit;
    *orow = wrow;
  }
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

// ---------------------------------------------------------------- stash ----
// K4 and K1 (and the sorted kernels, in their block's exchange buffer) keep
// in shared memory, for the two walks of a bounce, what the bounce carries
// across them but the walks never read: the path (29 words and the RNG)
// around both walks, and eight shading values (the uv, the material tag
// and index, the NEE cosine and importance) around the shadow walk. In
// registers they count on top of the walks' own, and they set the kernel's
// peak; stashed, K4 fits in 80 registers a thread (24 warps an SM) with no
// spill, where it needed 96. A thread's words lie kStride apart, the
// block's width (no bank conflict). The accesses are volatile so that the
// compiler reloads the values after the walk instead of keeping them live
// in registers. Pure data movement: the outputs are unchanged bit for bit.
constexpr int kStashPath = kNState + 1;     // the path's words: state, RNG
constexpr int kStashWords = kStashPath + 8;  // and the shading values
// the occlusion cache's prediction (kCache), past the sorted kernels' path
// id (kPidWord below)
constexpr int kPredWord = kStashWords + 1;
#define SHADE_STASH(X)                                                         \
  X(0, uvx) X(1, uvy) X(2, tag) X(3, midx) X(4, cosw) X(5, impr) X(6, impg)    \
  X(7, impb)

template <int kStride>
__device__ __forceinline__ void put_path(const Path& p, volatile float* my) {
#define PUT_FIELD(c, f) my[(c) * kStride] = p.f;
  STATE_FIELDS(PUT_FIELD)
#undef PUT_FIELD
  my[kNState * kStride] = __uint_as_float(p.rng);
}

template <int kStride>
__device__ __forceinline__ void get_path(Path& p, const volatile float* my) {
#define GET_FIELD(c, f) p.f = my[(c) * kStride];
  STATE_FIELDS(GET_FIELD)
#undef GET_FIELD
  p.rng = __float_as_uint(my[kNState * kStride]);
}

// One bounce of a live path (the body of _bounce_loop). kStash: keep the
// stash above in `my` (this thread's first word of the block's stash, whose
// words lie kStride apart). kGate: trace the shadow ray (and stash around
// it) only where NEE gates it in; elsewhere its tmax is -1, so it hits
// nothing and visits no row, and skipping it changes no output (K5).
// kFmt, kSh: the trace-row format and the dedicated shadow table
// (trace_closest, trace_any). kCache: the occlusion cache, `pred` the
// path's prediction (stashed around the closest walk).
template <bool kStash = false, int kStride = kThreads, bool kGate = false,
          int kFmt = 0, bool kSh = false, bool kCache = false>
__device__ void bounce(const Scene& S, Path& p, volatile float* my = nullptr,
                       int* pred = nullptr) {
  Hit h;
  if constexpr (kStash) {
    put_path<kStride>(p, my);
    if constexpr (kCache) my[kPredWord * kStride] = __int_as_float(*pred);
  }
  trace_closest<kFmt>(S, p, h);
  if constexpr (kStash) {
    get_path<kStride>(p, my);
    if constexpr (kCache) *pred = __float_as_int(my[kPredWord * kStride]);
  }
  if (!h.found) {
    p.alive = 0.0f;
    p.bounce = p.bounce + 1.0f;
    p.segs = p.segs + 1.0f;
    p.rows = p.rows + h.nit + 0.0f;
    return;
  }
  const float t = h.t, u = h.u, v = h.v;
  float tag = h.tag, midx = h.midx;  // stashed across the shadow walk
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
  // the shadow-visibility boxes (_bounce_loop, pallas_megakernel.py:
  // 2360-2378): a lane whose NEE origin lies in a box proven unoccluded
  // (closed f32 compares) skips its walk, visible; nbox is 0 when the
  // launch reads no box. skip_all (:2380-2385): every lane skips it
  bool walk_gate = gate && !S.skip_all;
  for (int k = 0; k < S.nbox && walk_gate; ++k) {
    const float* b = S.consts + S.box_off + 6 * k;
    if (hx >= b[0] && hx <= b[3] && hy >= b[1] && hy <= b[4] && hz >= b[2] &&
        hz <= b[5])
      walk_gate = false;
  }
  float nit_s = 0.0f;
  bool occluded = false;
  int orow = -1;  // the row that answered the shadow query (kCache)
  if (!kGate || walk_gate) {
    if constexpr (kStash) {
      put_path<kStride>(p, my);
      volatile float* x = my + kStashPath * kStride;
#define PUT_LOCAL(c, v) x[(c) * kStride] = v;
      SHADE_STASH(PUT_LOCAL)
#undef PUT_LOCAL
    }
    const float tmax = walk_gate ? sdist - kEps : -1.0f;
    if constexpr (kCache)
      occluded = trace_any<kFmt, kSh, true>(S, hx, hy, hz, sdx, sdy, sdz, kTwoEps, tmax,
                                            nit_s, walk_gate ? *pred : -1, &orow);
    else
      occluded = trace_any<kFmt, kSh>(S, hx, hy, hz, sdx, sdy, sdz, kTwoEps, tmax, nit_s);
    if constexpr (kStash) {
      get_path<kStride>(p, my);
      volatile float* x = my + kStashPath * kStride;
#define GET_LOCAL(c, v) v = x[(c) * kStride];
      SHADE_STASH(GET_LOCAL)
#undef GET_LOCAL
    }
  }
  if constexpr (kCache) {
    if (gate) *pred = orow;
  }

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

__device__ __forceinline__ bool going(const Path& p, float cap) {
  return p.alive > 0.0f && p.bounce < cap;
}

// a whole path to `cap` (K2)
template <int kFmt = 0, bool kSh = false, bool kCache = false>
__device__ void bounce_loop(const Scene& S, Path& p, float cap) {
  int pred = -1;  // kCache: the path's prediction
  while (going(p, cap)) {
    if constexpr (kCache) bounce<false, kThreads, false, kFmt, kSh, true>(S, p, nullptr, &pred);
    else bounce<false, kThreads, false, kFmt, kSh>(S, p);
  }
}

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
// What bounds it: as K1, the walk's dependent loads; on top, each pass
// costs the block a wait for its slowest warp, the sort's 36 stages (6
// through shared memory, each behind a barrier) and the exchange of every
// path. The design, for the H100:
// * occupancy: the bounce stashes the path in shared memory around its
//   walks, as K4 does, in the exchange buffer itself (a thread's column, the
//   block's stride), so 3 blocks of 256 threads fit an SM at 80 registers
//   (24 warps, no spill) in 41 KB of shared memory a block;
// * one word a sort stage: the key and the source lane are packed into one
//   int32 (hijiki_sort::block_sort_packed: the same network and tie rule,
//   so the same permutation);
// * the exchange takes no barrier of its own: each thread writes its path
//   and id to its own column before the sort (whose first barrier publishes
//   them) and reads its source lane's column after it; the loop's barrier
//   keeps the next pass's writes after every read (the id waits in the
//   column across the bounce, so no register holds it there).
// After the last pass the paths go back to their own lanes through the
// columns once more, so that a warp's writes to the outputs stay coalesced:
// writing each path straight to its own column of the outputs (a
// permutation within the tile's 256 columns) saves that exchange but read
// 0.1-3% slower (PERF.md).
//
// The tile: kSortTile = 256 lanes (a block of 256 threads). The TPU sorted
// its 1024-lane tile; any tile gives the same outputs (a pure permutation),
// and a 1024-thread block would cap the megakernel at 64 registers a thread
// (65,536 per SM). ops/megakernel.py::SORT_TILE must equal kSortTile.
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
constexpr int kDeadKey = 1 << 20;
// resident blocks an SM asked of ptxas for the sorted kernels: 768 threads
// (24 warps, 80 registers a thread) as K4
constexpr int kSortMinBlocks = 768 / kSortTile > 0 ? 768 / kSortTile : 1;
static_assert(kSortTile >= 64,
              "the sort's shared stages publish the exchange's writes");
// a column's word that holds the id of its path, past the stash's words
constexpr int kPidWord = kStashWords;
static_assert(kPredWord == kPidWord + 1, "the prediction's word follows the id's");

template <bool kCache = false>
struct SortShared {
  hijiki_sort::PackedScratch<kSortTile> sort;
  // a thread's column: its bounce's stash, then the path between the
  // passes' sorts; the path's id; with the cache, its prediction
  float path[kPidWord + 1 + (kCache ? 1 : 0)][kSortTile];
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

// The block's paths in the sorted lockstep: thread `lane` holds path `lane`
// of the tile, i = blockIdx.x * kSortTile + lane of n, before and after;
// `order` (nullable): the record of the last sort, at order[i] and
// order[n + i]. kCache: the path's prediction moves with it (kPredWord).
template <int kFmt = 0, bool kSh = false, bool kCache = false>
__device__ void bounce_loop_sorted(const Scene& S, Path& p, float cap, int n,
                                   int* order) {
  extern __shared__ __align__(16) unsigned char smem[];
  SortShared<kCache>& sh = *reinterpret_cast<SortShared<kCache>*>(smem);
  const int lane = threadIdx.x;
  volatile float* my = &sh.path[0][lane];
  int pid = lane;
  int pred = -1;  // kCache: the path's prediction
  while (__syncthreads_or(going(p, cap))) {
    my[kPidWord * kSortTile] = __int_as_float(pid);  // held here across the bounce
    if (going(p, cap)) {
      if constexpr (kCache) bounce<true, kSortTile, false, kFmt, kSh, true>(S, p, my, &pred);
      else bounce<true, kSortTile, false, kFmt, kSh>(S, p, my);
    }
    int key = lane_key(S, p);
    put_path<kSortTile>(p, my);
    if constexpr (kCache) my[kPredWord * kSortTile] = __int_as_float(pred);
    const int src = hijiki_sort::block_sort_packed<kSortTile, kDeadKey>(key, lane, sh.sort);
    get_path<kSortTile>(p, my + (src - lane));
    pid = __float_as_int(my[kPidWord * kSortTile + (src - lane)]);
    if constexpr (kCache) pred = __float_as_int(my[kPredWord * kSortTile + (src - lane)]);
  }
  const int i = blockIdx.x * kSortTile + lane;
  if (order != nullptr && i < n) {
    order[i] = blockIdx.x * kSortTile + pid;
    order[n + i] = lane_key(S, p);
  }
  // back to the path's own lane (the loop's last barrier follows every
  // read of the last pass)
  put_path<kSortTile>(p, my + (pid - lane));
  __syncthreads();
  get_path<kSortTile>(p, my);
}

// K2, the resume launch, in two modes chosen on the device from the count
// of its input's paths still going (alive, under the cap), with no host
// read. The count comes
// * from the compaction phases (ops/megakernel.py _run_compaction_phases),
//   which put the alive lanes first and hand K2 their count before the cut
//   (`hint`): K2 counts min(*hint, n) and takes its first lanes for the
//   going ones; or
// * elsewhere (hint null) from mk_resume_scan_kernel, launched before K2,
//   which counts the going paths into work[0] and lists them at work[2..]
//   (a ballot a warp, one atomicAdd of its count, each going lane at the
//   base + its rank; the list holds min(n, thr) of them, in no order).
// mk_resume then launches
// * mk_resume_kernel, the thread mode (one path a thread, the code K2
//   always had), which returns at once where the count is at most thr;
// * mk_resume_tail_kernel, the tail mode, which returns at once where it
//   is above: lane 0 of warp w of its grid takes the w-th going path (the
//   list's, or lane w) and runs it to the cap, the warp's other lanes idle;
//   then every thread copies the lanes that are not going, as one path a
//   thread would (it reads and writes them unchanged). A going lane that a
//   hint left out (a hint is never trusted for the outputs) is run there
//   by the thread that meets it.
// The mode that runs writes the count and its word at work[0..1]
// (kModeThread, kModeTail), which the wrapper can read after the launch.
// Neither mode changes an output: a path's trace depends only on its
// state, whichever thread runs it, so both give one path a thread's
// outputs bit for bit.
//
// Why: the tail launch (the cap max_bounces) lasts as long as its longest
// path, a few paths trapped in the mirror sphere bouncing hundreds of
// times, each bounce a chain of dependent instructions (7,254 cycles a
// bounce for the longest path alone on an NVIDIA H100 80GB HBM3 at 700 W,
// its closest walk 36% of them, the rows it visits held in L1; PERF.md
// §6, K2's tail mode). One path a thread packs the survivors 32 to a
// warp, which then steps through their diverging walks and shading
// together; a warp a path lets each run at its own pace, the SM's other
// warps hiding its latency. The tail bounce stashes the path in shared
// memory around its walks and traces a shadow ray only where NEE gates
// one in (bounce's kStash and kGate, as K4 and K5 do): 94-96 registers,
// 20 warps an SM (114-116 and 16 for the occlusion cache's classic and
// PACKED4 instantiations), no spill, where without the stash it spilled.
// Where the paths outnumber the warps the card holds, the lanes are
// better spent on 32 paths a warp: the wrapper's threshold `thr`
// (ops/megakernel.py resume_threshold) is the tail kernel's resident
// warps, -1 to force the thread mode, n to force the tail mode. Walking
// the closest ray 32 rows at a time with the warp's lanes read 1.4-1.8x
// slower there and is not kept (PERF.md §6).
//
// Two launches of which one returns at once, rather than one kernel with a
// uniform branch: a kernel's registers are the most any of its paths
// needs, and the thread mode keeps its own code and registers this way
// (its record in tests/test_torch_cuda.py FORMAT_OCCUPANCY) while the tail
// mode spills nothing. In one call against the two kernels, one kernel read
// the thread mode's launches 3-6.5% slower (128 threads a block), or up to
// 12% slower on some formats and 6% faster on others (capped at the tail's
// registers). Two ways of giving each copied lane a thread of its own read
// the 524,288-lane tail launches 4-5% faster and were not kept: the thread
// kernel copying the lanes no warp takes (every form of its skip cost it 4
// spilled bytes or a register past its record) and a tail grid of a thread
// a lane (it cost the thread mode's launches 1-3%; PERF.md §6, K2's tail
// mode).
constexpr int kModeThread = 1, kModeTail = 2;
constexpr int kScanThreads = 256;
// resident blocks an SM asked of ptxas for the tail mode (__launch_bounds__'
// second argument: it caps the registers, at 96 for 5 blocks, 128 for 4):
// 5, the most that spills nothing, but 4 for the occlusion cache's
// instantiations, which spilled 4 bytes at 5 in one build or another
template <bool kCache>
constexpr int kTailMinBlocks = kCache ? 4 : 5;

__device__ __forceinline__ bool going_at(const float* st, int i, int n, float cap) {
  return st[i] > 0.0f && st[static_cast<size_t>(n) + i] < cap;  // alive, bounce
}

// the going paths' count: the hint's, else the scan's
__device__ __forceinline__ int resume_count(const int* work, const long long* hint, int n) {
  if (hint == nullptr) return work[0];
  const long long h = *hint;
  return static_cast<int>(h < n ? (h < 0 ? 0 : h) : n);
}

__global__ void __launch_bounds__(kScanThreads)
    mk_resume_scan_kernel(const float* st_in, int n, float cap, int list_cap, int* work) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool go = i < n && going_at(st_in, i, n, cap);
  const unsigned m = __ballot_sync(kFull, go);
  if (m == 0u) return;
  const unsigned lane = threadIdx.x % 32u;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (static_cast<int>(lane) == leader) base = atomicAdd(work, __popc(m));
  base = __shfl_sync(kFull, base, leader);
  const int t = base + __popc(m & ((1u << lane) - 1u));
  if (go && t < list_cap) work[2 + t] = i;
}

// a going path of the tail mode, run to the cap by this thread, with the
// stash in its column `my` and the shadow gate
template <int kFmt, bool kSh, bool kCache>
__device__ __forceinline__ void tail_path(const Scene& S, const float* st_in,
                                          const uint32_t* rng_in, int n, float cap,
                                          float* st_out, uint32_t* rng_out, int i,
                                          volatile float* my) {
  Path p{};
  read_state(st_in, rng_in, i, n, p);
  int pred = -1;  // kCache: the path's prediction
  while (going(p, cap)) {
    if constexpr (kCache) bounce<true, kThreads, true, kFmt, kSh, true>(S, p, my, &pred);
    else bounce<true, kThreads, true, kFmt, kSh>(S, p, my);
  }
  write_state(p, st_out, rng_out, i, n);
}

__device__ __forceinline__ void copy_lane(const float* st_in, const uint32_t* rng_in, int n,
                                          float* st_out, uint32_t* rng_out, int i) {
#pragma unroll
  for (int c = 0; c < kNState; ++c)
    st_out[static_cast<size_t>(c) * n + i] = st_in[static_cast<size_t>(c) * n + i];
  rng_out[i] = rng_in[i];
}

template <int kFmt = 0, bool kSh = false, bool kCache = false>
__global__ void __launch_bounds__(kThreads)
    mk_resume_kernel(Scene S, const float* st_in, const uint32_t* rng_in, int n,
                     float cap, float* st_out, uint32_t* rng_out, int* work,
                     const long long* hint, int thr) {
  const int count = resume_count(work, hint, n);
  if (count <= thr) return;  // the tail mode's launch
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    work[0] = count;
    work[1] = kModeThread;
  }
  if (i >= n) return;
  Path p{};
  read_state(st_in, rng_in, i, n, p);
  bounce_loop<kFmt, kSh, kCache>(S, p, cap);
  write_state(p, st_out, rng_out, i, n);
}

// a grid of at least min(n, thr) warps (one block at least)
template <int kFmt = 0, bool kSh = false, bool kCache = false>
__global__ void __launch_bounds__(kThreads, kTailMinBlocks<kCache>)
    mk_resume_tail_kernel(Scene S, const float* st_in, const uint32_t* rng_in, int n,
                          float cap, float* st_out, uint32_t* rng_out, int* work,
                          const long long* hint, int thr) {
  __shared__ float stash[(kCache ? kPredWord + 1 : kStashWords) * kThreads];
  volatile float* my = stash + threadIdx.x;
  const int count = resume_count(work, hint, n);
  if (count > thr) return;  // the thread mode's launch
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid == 0) {
    work[0] = count;
    work[1] = kModeTail;
  }
  const bool listed = hint == nullptr;  // the scan listed every going lane
  const int w = tid / 32;
  const int stride = gridDim.x * blockDim.x;
  // this thread's lanes: first (k = -1, lane 0 of warp w < count) the w-th
  // going path, then every stride-th lane from tid that no warp takes (a
  // going one is past a hint's count: this thread runs it); one call site
  // of the path's code, which inlined twice spilled
  for (int k = threadIdx.x % 32u == 0u && w < count ? -1 : 0;; ++k) {
    int i = k < 0 ? (listed ? work[2 + w] : w) : tid + k * stride;
    if (k >= 0) {
      if (i >= n) break;
      if (listed ? going_at(st_in, i, n, cap) : i < count) continue;  // a warp's
    }
    if (going_at(st_in, i, n, cap))
      tail_path<kFmt, kSh, kCache>(S, st_in, rng_in, n, cap, st_out, rng_out, i, my);
    else
      copy_lane(st_in, rng_in, n, st_out, rng_out, i);
  }
}

// The sorted K1 and K2 (mk_start_sorted, mk_resume_sorted): a block's
// threads past the last path carry a dead path to the end.
template <int kFmt = 0, bool kSh = false, bool kCache = false>
__global__ void __launch_bounds__(kSortTile, kSortMinBlocks)
    mk_start_sorted_kernel(Scene S, const float* px, const float* py,
                           const uint32_t* seeds, int n, float cap, float* st_out,
                           uint32_t* rng_out, int* order) {
  const int i = blockIdx.x * kSortTile + threadIdx.x;
  Path p{};
  if (i < n) camera_init(S, px[i], py[i], seeds[i], p);
  bounce_loop_sorted<kFmt, kSh, kCache>(S, p, cap, n, order);
  if (i < n) write_state(p, st_out, rng_out, i, n);
}

template <int kFmt = 0, bool kSh = false, bool kCache = false>
__global__ void __launch_bounds__(kSortTile, kSortMinBlocks)
    mk_resume_sorted_kernel(Scene S, const float* st_in, const uint32_t* rng_in,
                            int n, float cap, float* st_out, uint32_t* rng_out,
                            int* order) {
  const int i = blockIdx.x * kSortTile + threadIdx.x;
  Path p{};
  if (i < n) read_state(st_in, rng_in, i, n, p);
  bounce_loop_sorted<kFmt, kSh, kCache>(S, p, cap, n, order);
  if (i < n) write_state(p, st_out, rng_out, i, n);
}

// K4, the chained camera launch (_megakernel_start_chained with the chain
// block of _bounce_loop, pallas_megakernel.py:2618-2681), K1, the
// unchained one (_megakernel_start), and K5, the single-launch render
// (_megakernel/_megakernel_body): a persistent, bounce-granular path loop.
//
// The work items are the nsamp * n slots in slot order samp * n + lane, so
// that a warp's run of consecutive slots is consecutive pixels of one
// sample (coherent camera rays); K1 and K5 are the loop at nsamp = 1,
// slot = path.
// The launch holds as many blocks as the SMs keep resident at once (the
// occupancy of the kernel as built). Each thread loops: if it holds no path
// it takes a slot, if it holds one it runs ONE bounce of it, and when that
// path has stopped (dead, or at `cap`) it writes it out. Slots are fetched
// by the warp: a ballot of the lanes that need one, one atomicAdd of their
// number on a device counter (zeroed by the wrapper on the stream), the
// base broadcast by a shuffle, each such lane taking base + its rank among
// them. A lane past the last slot stays idle; a warp leaves when the
// counter is spent and none of its lanes holds a path. Every lane reaches
// both ballots in every iteration (the SASS closes every divergent region
// of the loop body, BSSY/BSYNC, before them), so the warp is converged
// there.
//
// A slot's sample starts as a fresh camera ray from pxs/pys/seeds[slot]
// and, when it stops, K1 writes its state to column `slot` of its (29, n)
// output and its RNG to the (n,) RNG output, as one path a thread would;
// K5 writes its 7 result channels and its RNG likewise (write_tile).
// K4's stopped sample is
//   * parked, if still alive: its full state goes to column `slot` of the
//     (29, nsamp*n) pool and of the (nsamp*n,) RNG pool, and the compaction
//     phases resume it later (no sample is dropped), or
//   * flushed, if dead: its 12 CHAIN_OUT_CH values (Lr,Lg,Lb, n1,n2,n3,
//     depth, segs, rows, ar,ag,ab) go to column `slot` of the (12, nsamp*n)
//     flush buffer, and its final RNG to the RNG pool.
// The wrapper zeroes the pool and the flush buffer: an empty pool slot must
// read alive = 0, and a parked slot's flush column must read 0 until its
// resume commits it (writing those zeros here read slower than the memset).
// The TPU kernel selected a sample's slot with a where-chain over S and
// wrote every slot masked; here a slot is indexed directly. The outputs are
// in the (C, nsamp*n) layout the compaction phases consume. The RNG pool
// also receives flushed samples' final states (the TPU kernel leaves those
// slots 0), so the chained driver returns per sweep the same RNG states as
// separate sweeps. Which thread traces a slot, and when, does not change
// the outputs: a slot's path depends only on its inputs.
//
// What bounds it: the dependent loads of the walk and the divergence of a
// warp's threads. A loop of whole samples per thread keeps a warp on each
// sample until its slowest lane's path ends (nvcc wraps that bounce loop in
// BSSY/BSYNC: lanes whose sample stopped wait at the BSYNC), a cost of the
// sum over samples of the warp's longest path; here a lane takes its next
// slot one bounce after its path stops, as the TPU kernel's chain block
// respawned a lane. On the H100, at 1024x1024 x 8 samples, the whole-sample
// loop costs 1.61x the warp-bounces of perfect packing (mk.warp_iterations),
// yet this loop alone gains only ~3% over it (tools/ab_megakernel_torch.py):
// a warp-bounce with few lanes active moves fewer rows, so idle lanes cost
// less than their count, and a warp's lanes no longer share their sample's
// coherent camera bounce. The inlined slot start and finish raise the
// kernel to 120 registers (16 warps an SM); capped at 96 (20 warps, no
// spill) the loop gains ~14%, and with the stash at 80 (24 warps, no spill)
// another ~5% (PERF.md).

// resident blocks an SM asked of ptxas for K4, K1 and K5 (__launch_bounds__'
// second argument: it caps the registers a thread, 80 at 6 blocks); with
// the stash 6 is the most that spills nothing
constexpr int kPersistMinBlocks = 6;

// a slot's fresh camera path (its sample: slot / n)
__device__ __forceinline__ void chain_start(const Scene& S, const float* pxs,
                                            const float* pys,
                                            const uint32_t* seeds, int n,
                                            int slot, Path& p) {
  camera_init(S, pxs[slot], pys[slot], seeds[slot], p);
  const int s = slot / n;
  if (s != 0) p.samp = static_cast<float>(s);  // sample 0 keeps px * 0
}

// K4's finish: park or flush a stopped path at `slot` of the sn slots
struct ChainFinish {
  int sn;
  float* pool;
  uint32_t* pool_rng;
  float* chain_out;
  __device__ __forceinline__ void operator()(const Path& p, int slot) const {
    pool_rng[slot] = p.rng;
    if (p.alive > 0.0f) {  // park
#define PARK_FIELD(c, f) pool[static_cast<size_t>(c) * sn + slot] = p.f;
      STATE_FIELDS(PARK_FIELD)
#undef PARK_FIELD
    } else {  // flush
      const float vals[kChainOut] = {p.Lr, p.Lg, p.Lb, p.n1, p.n2, p.n3,
                                     p.depth, p.segs, p.rows, p.ar, p.ag, p.ab};
#pragma unroll
      for (int c = 0; c < kChainOut; ++c)
        chain_out[static_cast<size_t>(c) * sn + slot] = vals[c];
    }
  }
};

// K1's finish: the state of the stopped path at column `slot` of n
struct StateFinish {
  int n;
  float* st;
  uint32_t* rng;
  __device__ __forceinline__ void operator()(const Path& p, int slot) const {
    write_state(p, st, rng, slot, n);
  }
};

// K5's result: only the 7 channels (Lr,Lg,Lb, n1,n2,n3, depth) and the RNG
// of the path at column i of n; no 29-channel state
__device__ __forceinline__ void write_tile(const Path& p, float* out,
                                           uint32_t* rng_out, int i, int n) {
  const float vals[kTileOut] = {p.Lr, p.Lg, p.Lb, p.n1, p.n2, p.n3, p.depth};
#pragma unroll
  for (int c = 0; c < kTileOut; ++c) out[static_cast<size_t>(c) * n + i] = vals[c];
  rng_out[i] = p.rng;
}

// K5's finish: the result of the stopped path at column `slot` of n
struct TileFinish {
  int n;
  float* out;
  uint32_t* rng;
  __device__ __forceinline__ void operator()(const Path& p, int slot) const {
    write_tile(p, out, rng, slot, n);
  }
};

template <bool kGate = false, int kFmt = 0, bool kSh = false, bool kCache = false,
          typename Finish>
__device__ __forceinline__ void persistent_paths(const Scene& S, const float* pxs,
                                                 const float* pys,
                                                 const uint32_t* seeds, int n,
                                                 int nsamp, float cap, int* next,
                                                 const Finish& finish) {
  const int sn = nsamp * n;
  const unsigned lane = threadIdx.x % 32u;
  const unsigned below = (1u << lane) - 1u;  // the lanes ranked before this one
  __shared__ float stash[(kCache ? kPredWord + 1 : kStashWords) * kThreads];
  volatile float* my = stash + threadIdx.x;
  Path p{};
  int pred = -1;       // kCache: the prediction of the path held
  int slot = -1;       // the slot whose path this thread holds; -1: none
  bool spent = false;  // the counter is past the last slot (warp-uniform)
  for (;;) {
    const unsigned need = __ballot_sync(kFull, slot < 0);
    if (need != 0u && !spent) {  // warp-uniform: one atomicAdd for the warp
      const int leader = __ffs(need) - 1;
      int base = 0;
      if (static_cast<int>(lane) == leader) base = atomicAdd(next, __popc(need));
      base = __shfl_sync(kFull, base, leader);
      spent = base + __popc(need) >= sn;
      const int mine = base + __popc(need & below);
      if (slot < 0 && mine < sn) {
        slot = mine;
        chain_start(S, pxs, pys, seeds, n, slot, p);
        if constexpr (kCache) pred = -1;
      }
    }
    if (__ballot_sync(kFull, slot >= 0) == 0u) return;
    if (slot >= 0) {
      if (going(p, cap)) {
        if constexpr (kCache) bounce<true, kThreads, kGate, kFmt, kSh, true>(S, p, my, &pred);
        else bounce<true, kThreads, kGate, kFmt, kSh>(S, p, my);
      }
      if (!going(p, cap)) {
        finish(p, slot);
        slot = -1;
      }
    }
  }
}

template <int kFmt = 0, bool kSh = false, bool kCache = false>
__global__ void __launch_bounds__(kThreads, kPersistMinBlocks)
    mk_start_chained_kernel(Scene S, const float* pxs, const float* pys,
                            const uint32_t* seeds, int n, int nsamp, float cap,
                            float* pool, uint32_t* pool_rng, float* chain_out,
                            int* next) {
  persistent_paths<false, kFmt, kSh, kCache>(S, pxs, pys, seeds, n, nsamp, cap, next,
                                     ChainFinish{nsamp * n, pool, pool_rng, chain_out});
}

template <int kFmt = 0, bool kSh = false, bool kCache = false>
__global__ void __launch_bounds__(kThreads, kPersistMinBlocks)
    mk_start_kernel(Scene S, const float* px, const float* py,
                    const uint32_t* seeds, int n, float cap, float* st_out,
                    uint32_t* rng_out, int* next) {
  persistent_paths<false, kFmt, kSh, kCache>(S, px, py, seeds, n, 1, cap, next,
                                     StateFinish{n, st_out, rng_out});
}

// K5, the single-launch render (_megakernel/_megakernel_body): camera ray
// and bounces to `cap`, then only the result (write_tile). Persistent, as
// K1 is, or sorted (mk_tiles_sorted).
//
// What bounds it, beside the walk's chain: a few paths of a frame (trapped
// inside the mirror sphere, where Russian roulette's q stays at 0.99)
// bounce hundreds of times. One path a thread held each such path's warp,
// and its slot on the SM, to the end; here the warp's other lanes take new
// paths meanwhile. What no schedule shortens is the longest path's own
// chain from the time its slot is taken (tools/ab_megakernel_torch.py
// times K5 on a frame's 32 longest paths alone: the tail floor). That
// chain is ~60% of K5 on the H100, and the stash adds to each of its
// bounces; so K5 traces a shadow ray, and stashes around it, only where NEE
// needs one (kGate: a path in the mirror sphere needs none). Leaving the
// warp's votes once the counter is spent read no faster (PERF.md).
template <int kFmt = 0, bool kSh = false, bool kCache = false>
__global__ void __launch_bounds__(kThreads, kPersistMinBlocks)
    mk_tiles_kernel(Scene S, const float* px, const float* py,
                    const uint32_t* seeds, int n, float cap, float* out,
                    uint32_t* rng_out, int* next) {
  persistent_paths<true, kFmt, kSh, kCache>(S, px, py, seeds, n, 1, cap, next,
                                    TileFinish{n, out, rng_out});
}

template <int kFmt = 0, bool kSh = false, bool kCache = false>
__global__ void __launch_bounds__(kSortTile, kSortMinBlocks)
    mk_tiles_sorted_kernel(Scene S, const float* px, const float* py,
                           const uint32_t* seeds, int n, float cap, float* out,
                           uint32_t* rng_out, int* order) {
  const int i = blockIdx.x * kSortTile + threadIdx.x;
  Path p{};
  if (i < n) camera_init(S, px[i], py[i], seeds[i], p);
  bounce_loop_sorted<kFmt, kSh, kCache>(S, p, cap, n, order);
  if (i < n) write_tile(p, out, rng_out, i, n);
}

// the scene's trace-row format is one the kernels have
__host__ __forceinline__ bool known_format(const Scene& S) {
  const bool fmt = S.packed == 0 || S.packed == 1 || S.packed == 3 ||
                   S.packed == 4 || S.packed == 12;
  // the dedicated shadow table goes with classic rows only (compile_scene)
  // and without the cache (which predicts rows of the main table)
  return fmt && (S.shadow_rows == nullptr || (S.packed == 0 && !S.cache));
}
// an instantiation's index among each kernel's: 0 the classic rows, 1-4 the
// packed tables of 1, 3, 4 and 12 prims a row, 5 the classic rows with the
// dedicated shadow table, 6-10 those of 0-4 with the occlusion cache
constexpr int kFormats = 11;
constexpr int kCacheBase = 6;
__host__ __forceinline__ int fmt_index(const Scene& S) {
  const int f = S.packed == 1    ? 1
                : S.packed == 3  ? 2
                : S.packed == 4  ? 3
                : S.packed == 12 ? 4
                : S.shadow_rows  ? 5
                                 : 0;
  return S.cache ? kCacheBase + f : f;
}
// the instantiation of the kernel template `k` of index f
#define FMT_KERNEL_AT(f, k)                                                    \
  ((f) == 1    ? &k<1, false, false>                                           \
   : (f) == 2  ? &k<3, false, false>                                           \
   : (f) == 3  ? &k<4, false, false>                                           \
   : (f) == 4  ? &k<12, false, false>                                          \
   : (f) == 5  ? &k<0, true, false>                                            \
   : (f) == 6  ? &k<0, false, true>                                            \
   : (f) == 7  ? &k<1, false, true>                                            \
   : (f) == 8  ? &k<3, false, true>                                            \
   : (f) == 9  ? &k<4, false, true>                                            \
   : (f) == 10 ? &k<12, false, true>                                           \
               : &k<0, false, false>)
#define FMT_KERNEL(S, k) FMT_KERNEL_AT(fmt_index(S), k)
// the sorted kernels' dynamic shared memory: the exchange buffer of the
// instantiation of index f
__host__ __forceinline__ size_t sorted_smem(int f) {
  return f >= kCacheBase ? sizeof(SortShared<true>) : sizeof(SortShared<false>);
}

// the launch of K2: blocks of kThreads paths, or of kSortTile with the
// exchange buffer in `smem` bytes of dynamic shared memory for the sorted
// kernels (opting in past 48 KB, which only tiles of 512 lanes and more need)
template <bool kSort, typename... Params, typename... Args>
int launch_paths(void (*kernel)(Params...), int n, size_t smem, void* stream,
                 Args... args) {
  constexpr int block = kSort ? kSortTile : kThreads;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<(n + block - 1) / block, block, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// the launch of K4, K1 and K5: the SMs times the blocks an SM holds at once, no
// more blocks than the `slots` fill
template <typename... Params, typename... Args>
int launch_persistent(void (*kernel)(Params...), int slots, void* stream,
                      Args... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int fill = (slots + kThreads - 1) / kThreads;
  const int blocks = fill < sms * per_sm ? fill : sms * per_sm;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1/K2/K5 and their sorted variants; `order` (sorted only) may be null
#define START_ARGS                                                             \
  SCENE_ARGS, const float *px, const float *py, const uint32_t *seeds, int n,  \
      int cap
#define RESUME_ARGS                                                            \
  SCENE_ARGS, const float *st_in, const uint32_t *rng_in, int n, int cap

// K1; `next`: the work counter, zeroed on the stream
extern "C" int mk_start(START_ARGS, float* st_out, uint32_t* rng_out, int* next,
                        void* stream) {
  const Scene S = SCENE_CALL;
  if (!known_format(S)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_persistent(FMT_KERNEL(S, mk_start_kernel), n, stream, S, px, py, seeds, n,
                           static_cast<float>(cap), st_out, rng_out, next);
}

extern "C" int mk_start_sorted(START_ARGS, float* st_out, uint32_t* rng_out,
                               int* order, void* stream) {
  const Scene S = SCENE_CALL;
  if (!known_format(S)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_paths<true>(FMT_KERNEL(S, mk_start_sorted_kernel), n,
                            sorted_smem(fmt_index(S)), stream, S, px, py, seeds, n,
                            static_cast<float>(cap), st_out, rng_out, order);
}

// K2's survivors (mk_resume_scan_kernel): `work` holds 2 + min(n, max(thr,
// 0)) ints, its first zeroed on the stream
extern "C" int mk_resume_scan(const float* st_in, int n, int cap, int thr, int* work,
                              void* stream) {
  const int list_cap = thr < 0 ? 0 : (thr < n ? thr : n);
  mk_resume_scan_kernel<<<(n + kScanThreads - 1) / kScanThreads, kScanThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(st_in, n, static_cast<float>(cap),
                                                               list_cap, work);
  return static_cast<int>(cudaGetLastError());
}

// K2: the thread mode where more than thr paths go on, else the tail mode
// (the note above). `hint`: the compaction's count of alive lanes, put
// first (a device int64), or null after mk_resume_scan with the same
// `thr` and `work`; `work` holds 2 ints at least
extern "C" int mk_resume(RESUME_ARGS, float* st_out, uint32_t* rng_out, int* work,
                         const long long* hint, int thr, void* stream) {
  const Scene S = SCENE_CALL;
  if (!known_format(S)) return static_cast<int>(cudaErrorInvalidValue);
  const float fcap = static_cast<float>(cap);
  int rc = launch_paths<false>(FMT_KERNEL(S, mk_resume_kernel), n, 0, stream, S, st_in, rng_in,
                               n, fcap, st_out, rng_out, work, hint, thr);
  if (rc != 0) return rc;
  // a warp a going path (one block at least: with none it copies every lane)
  const int warps = thr < 1 ? 1 : (thr < n ? thr : n);
  constexpr int kWarpsBlock = kThreads / 32;
  const auto tail = FMT_KERNEL(S, mk_resume_tail_kernel);
  tail<<<(warps + kWarpsBlock - 1) / kWarpsBlock, kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(S, st_in, rng_in, n, fcap, st_out, rng_out, work,
                                              hint, thr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mk_resume_sorted(RESUME_ARGS, float* st_out, uint32_t* rng_out,
                                int* order, void* stream) {
  const Scene S = SCENE_CALL;
  if (!known_format(S)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_paths<true>(FMT_KERNEL(S, mk_resume_sorted_kernel), n,
                            sorted_smem(fmt_index(S)), stream, S, st_in, rng_in, n,
                            static_cast<float>(cap), st_out, rng_out, order);
}

// K5; `next`: the work counter, zeroed on the stream
extern "C" int mk_tiles(START_ARGS, float* out, uint32_t* rng_out, int* next,
                        void* stream) {
  const Scene S = SCENE_CALL;
  if (!known_format(S)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_persistent(FMT_KERNEL(S, mk_tiles_kernel), n, stream, S, px, py, seeds, n,
                           static_cast<float>(cap), out, rng_out, next);
}

extern "C" int mk_tiles_sorted(START_ARGS, float* out, uint32_t* rng_out,
                               int* order, void* stream) {
  const Scene S = SCENE_CALL;
  if (!known_format(S)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_paths<true>(FMT_KERNEL(S, mk_tiles_sorted_kernel), n,
                            sorted_smem(fmt_index(S)), stream, S, px, py, seeds, n,
                            static_cast<float>(cap), out, rng_out, order);
}

// K4; `next`: the work counter, zeroed on the stream
extern "C" int mk_start_chained(SCENE_ARGS, const float* pxs, const float* pys,
                                const uint32_t* seeds, int n, int nsamp, int cap,
                                float* pool, uint32_t* pool_rng, float* chain_out,
                                int* next, void* stream) {
  const Scene S = SCENE_CALL;
  if (!known_format(S)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_persistent(FMT_KERNEL(S, mk_start_chained_kernel), nsamp * n, stream, S,
                           pxs, pys, seeds, n, nsamp, static_cast<float>(cap), pool,
                           pool_rng, chain_out, next);
}

namespace {
template <typename... Params>
int occupancy(void (*kernel)(Params...), int threads, int smem, int* out) {
  cudaFuncAttributes attr{};
  int dev = 0;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, threads, smem);
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, dev);
  out[0] = attr.numRegs;
  out[2] = threads;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(rc);
}
}  // namespace

// What the card makes of a megakernel as built: out[0] registers a thread,
// out[1] resident blocks an SM, out[2] threads a block, out[3] SMs, out[4]
// local (spill) bytes a thread. which % 8: 0 K1 mk_start, 1 K2 mk_resume,
// 2 K4 mk_start_chained, 3 K5 mk_tiles, 4-6 the sorted K1/K2/K5 (blocks of
// kSortTile threads with launch_paths' dynamic shared memory), 7 K2's tail
// mode mk_resume_tail (its resident warps are the wrapper's threshold); which / 8:
// the instantiation (fmt_index: the format, the cache). K4, K1 and K5,
// persistent, launch out[1] * out[3] blocks (fewer where their slots fill
// fewer).
extern "C" int mk_occupancy(int which, int* out) {
  const int f = which / 8;
  if (which < 0 || f >= kFormats) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sorted_smem(f));
  switch (which % 8) {
    case 0: return occupancy(FMT_KERNEL_AT(f, mk_start_kernel), kThreads, 0, out);
    case 1: return occupancy(FMT_KERNEL_AT(f, mk_resume_kernel), kThreads, 0, out);
    case 2: return occupancy(FMT_KERNEL_AT(f, mk_start_chained_kernel), kThreads, 0, out);
    case 3: return occupancy(FMT_KERNEL_AT(f, mk_tiles_kernel), kThreads, 0, out);
    case 4: return occupancy(FMT_KERNEL_AT(f, mk_start_sorted_kernel), kSortTile, smem, out);
    case 5: return occupancy(FMT_KERNEL_AT(f, mk_resume_sorted_kernel), kSortTile, smem, out);
    case 6: return occupancy(FMT_KERNEL_AT(f, mk_tiles_sorted_kernel), kSortTile, smem, out);
    case 7: return occupancy(FMT_KERNEL_AT(f, mk_resume_tail_kernel), kThreads, 0, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

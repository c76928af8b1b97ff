// Walker-cost probes for Hopper (sm_90a): K10a walk_ablate and K10b
// walk_isolate. Timing probes, not render kernels: the slope of their time
// over two trip counts (hijiki_tpu_torch/probes/timing.py) prices one step
// of the per-thread walk that K1-K6 run.
//
// walk_ablate replaces tools/ablate_walker.py::_body_kernel / run_variant
// (pallas_call at :187) and its VARIANTS table (:210): a fixed-trip clone of
// the walker body whose cursor follows the real table's exit pointers
// (wrapped at the end, so every variant makes the same number of steps and
// the addresses stay data-dependent), with six parts switched by kFlags:
//   fetch     load the cursor's row (else row 0 stays in registers);
//   prefetch  load both candidate successors (cur + 1 and the exit pointer in
//             column 10) as soon as the row is known, and select one after
//             the vote (ablate_walker.py:92-94,157-159): the GPU way to take
//             the load off the cursor chain, priced by this probe;
//   slab      the interior row's slab test (else: never descend);
//   reduce    descend when any thread of the cursor group passes the slab
//             test (else the group's first thread decides, __shfl_sync);
//   prim      the triangle test and its accept (normal in columns 29-31);
//   count     the visit counter.
// kG threads share one cursor: kG = 1 is the port's design (a thread per
// cursor); kG = 32 is a warp per cursor with descend = __any_sync, the TPU's
// packet 32 lanes wide. At kG = 1, `noreduce` is the same program as `full`
// (a group of one votes alone). The TPU kernel's (n_tiles, 3, 8, P) blocks
// become channel-major (3, N) rays; groups are kG consecutive rays.
// Kept bit for bit: the fixed trip count, the wrap nxt - num_rows, the clamp
// min(cur, num_rows - 1) of _fetch_rows8, the exit pointer read f32 -> int32,
// t starting at 3e38 + ox * 0, and both output planes
// (min(t, 1e6) + nit + u; min(wrow, 1e6) + cur).
//
// walk_isolate replaces tools/walk_probe.py::walk_kernel / make_runner.run
// (pallas_call at :84): the real walk on camera or random rays, outside the
// bounce loop: the analytic pretest, then the closest-hit walk from the
// octant table of the ray's direction, stopped before the winner resolve;
// out: t and the rows visited per ray. kW: the classic 32-column table or
// make_w16_scene's 16 columns (normal in columns 11-13); kTest = false:
// every prim row misses (patch_no_test). It runs walk() of walk.cuh, the
// render kernels' own walk: kG = 1 a thread a ray, kG = 32 a warp as one
// 32-ray packet (the TPU's packet walk at 32 lanes), so the rows visited per
// ray at kG = 1 and kG = 32 show what a shared cursor costs in visits. Each
// of the `iters` trips walks other rays (ray i + trip * kRayStride, mod n;
// the last trip walks ray i), so no trip finds its rows in L1 because the
// trip before walked the same ray. The packed formats are not ported, so
// neither are the tool's packed/pack3/pack4/slim variants.
//
// What bounds them: a chain of dependent row loads (the row's exit pointer
// is the next address) whose latency one thread cannot hide; the table
// (1.2 MB) lives in L2. The probes exist to measure that chain.
//
// Numerics as in megakernel.cu (--fmad=false, IEEE division, NaN-propagating
// min/max); the plain PyTorch twins are hijiki_tpu_torch/probes/
// ablate_walker.py::walk_ablate_plain and walk_probe.py::walk_isolate_plain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe.cuh"

namespace {

constexpr int kFetch = 1, kPrefetch = 2, kSlab = 4, kReduce = 8, kPrim = 16,
              kCount = 32;
constexpr float kCap = 1000000.0f;  // f32(1e6)
// walk_isolate's ray step from one trip to the next: 67 warps' rays (67 is
// prime, so unless the warp count is a multiple of 67 a thread's trips walk
// every warp's rays before one repeats)
constexpr int kRayStride = 67 * 32;

// the columns of a 32-column row the walker body reads: 0-10, 29-31
struct Row {
  float c[11];
  float n[3];
};

__device__ __forceinline__ Row load_row(const float* rows, int num_rows, int cur) {
  const float* r = rows + static_cast<size_t>(min(cur, num_rows - 1)) * kRowW;
  Row w;
#pragma unroll
  for (int j = 0; j < 11; ++j) w.c[j] = r[j];
#pragma unroll
  for (int j = 0; j < 3; ++j) w.n[j] = r[29 + j];
  return w;
}

__device__ __forceinline__ Row select_row(bool a, const Row& x, const Row& y) {
  Row w;
#pragma unroll
  for (int j = 0; j < 11; ++j) w.c[j] = a ? x.c[j] : y.c[j];
#pragma unroll
  for (int j = 0; j < 3; ++j) w.n[j] = a ? x.n[j] : y.n[j];
  return w;
}

template <int kFlags, int kG>
__global__ void walk_ablate_kernel(const float* __restrict__ rows, int num_rows,
                                   const float* __restrict__ o,
                                   const float* __restrict__ d, int n, int iters,
                                   float* __restrict__ out) {
  constexpr bool fetch = kFlags & kFetch, prefetch = kFlags & kPrefetch;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // n % kG == 0: a group is all in or all out
  const float ox = o[i], oy = o[n + i], oz = o[2 * n + i];
  const float dx = d[i], dy = d[n + i], dz = d[2 * n + i];
  const float tmin = kEps;
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float tox = -ox * ix, toy = -oy * iy, toz = -oz * iz;
  int cur = 0;
  Row rw = load_row(rows, num_rows, cur);
  float t = kBig + ox * 0.0f, u = ox * 0.0f, v = ox * 0.0f, nit = ox * 0.0f;
  int wrow = num_rows;
  for (int it = 0; it < iters; ++it) {
    if constexpr (fetch && !prefetch) rw = load_row(rows, num_rows, cur);
    const float kind = rw.c[9];
    const int nexit = static_cast<int>(rw.c[10]);
    Row fa, fb;
    if constexpr (fetch && prefetch) {
      fa = load_row(rows, num_rows, cur + 1);
      fb = load_row(rows, num_rows, nexit);
    }
    const bool is_prim = kind >= 0.0f;
    const float best_t = t;
    bool slab = false;
    if constexpr ((kFlags & kSlab) != 0) {
      float ax = rw.c[0] * ix + tox, bx = rw.c[3] * ix + tox;
      float ay = rw.c[1] * iy + toy, by = rw.c[4] * iy + toy;
      float az = rw.c[2] * iz + toz, bz = rw.c[5] * iz + toz;
      float t0 = jmax(jmax(jmin(ax, bx), jmin(ay, by)), jmin(az, bz));
      float t1 = jmin(jmin(jmax(ax, bx), jmax(ay, by)), jmax(az, bz));
      slab = (t0 < t1 + kEps) && (t0 < best_t) && (t1 > tmin);
    }
    const bool descend = (kFlags & kReduce) ? group_any<kG>(slab && !is_prim)
                                            : group_first<kG>(slab) && !is_prim;
    if constexpr ((kFlags & kPrim) != 0) {
      const float *c = rw.c, *nr = rw.n;
      float rx = ox - c[0], ry = oy - c[1], rz = oz - c[2];
      float qx = ry * dz - rz * dy;
      float qy = rz * dx - rx * dz;
      float qz = rx * dy - ry * dx;
      float dd = 1.0f / (dx * nr[0] + dy * nr[1] + dz * nr[2]);
      float pu = -dd * (qx * c[6] + qy * c[7] + qz * c[8]);
      float pv = dd * (qx * c[3] + qy * c[4] + qz * c[5]);
      float t_pq = -dd * (nr[0] * rx + nr[1] * ry + nr[2] * rz);
      bool in_tri = (pu >= 0.0f) && (pv >= 0.0f) && (pu + pv <= 1.0f);
      bool ok_pq = in_tri && (tmin <= t_pq) && (t_pq <= best_t);
      if (is_prim && ok_pq && t_pq < best_t) {
        t = t_pq;
        u = pu;
        v = pv;
        wrow = cur;
      }
    }
    const bool take_exit = is_prim || !descend;
    int nxt = take_exit ? nexit : cur + 1;
    cur = nxt >= num_rows ? nxt - num_rows : nxt;
    if constexpr (fetch && prefetch) rw = select_row(take_exit, fb, fa);
    if constexpr ((kFlags & kCount) != 0) nit = nit + 1.0f;
  }
  out[i] = jmin(t, kCap) + nit + u;
  out[n + i] = jmin(static_cast<float>(wrow), kCap) + static_cast<float>(cur);
}

template <int kW, bool kTest, int kG>
__global__ void walk_isolate_kernel(Scene S, const float* __restrict__ o,
                                    const float* __restrict__ d, int n, int iters,
                                    float* __restrict__ t_out,
                                    float* __restrict__ nit_out) {
  constexpr int kNrm = kW == 16 ? 11 : 29;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // n % kG == 0: a trip's rays keep the warp's lanes together
  float bt, bu, bv, nit, tmin = kEps;
  int wrow;
  for (int it = iters - 1; it >= 0; --it) {  // iters >= 1: the slope's trip count
    const int j = static_cast<int>((i + static_cast<long long>(it) * kRayStride) % n);
    const float ox = o[j], oy = o[n + j], oz = o[2 * n + j];
    const float dx = d[j], dy = d[n + j], dz = d[2 * n + j];
    bt = kBig;
    bu = bv = 0.0f;
    wrow = S.total_rows + S.na;
    analytic_pretest(S, ox, oy, oz, dx, dy, dz, tmin, bt, bu, bv, wrow);
    bool unused = false;
    nit = walk<kW, kNrm, kTest, kG>(S, ox, oy, oz, dx, dy, dz, tmin, kBig, false, unused,
                                    bt, bu, bv, wrow);
    tmin = kEps + bt * 0.0f;  // kEps again (bt is finite), but the next walk waits for this one
  }
  t_out[i] = bt;
  nit_out[i] = nit;
}

template <int kFlags>
int ablate_group(int group, const float* rows, int num_rows, const float* o,
                 const float* d, int n, int iters, int block, float* out, int* occ,
                 void* stream) {
  if (group == 1)
    return launch(walk_ablate_kernel<kFlags, 1>, n, block, 0, occ, stream, rows,
                  num_rows, o, d, n, iters, out);
  if (group == 32)
    return launch(walk_ablate_kernel<kFlags, 32>, n, block, 0, occ, stream, rows,
                  num_rows, o, d, n, iters, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kW, bool kTest>
int isolate_group(int group, Scene S, const float* o, const float* d, int n,
                  int iters, int block, float* t_out, float* nit_out, int* occ,
                  void* stream) {
  if (group == 1)
    return launch(walk_isolate_kernel<kW, kTest, 1>, n, block, 0, occ, stream, S, o,
                  d, n, iters, t_out, nit_out);
  if (group == 32)
    return launch(walk_isolate_kernel<kW, kTest, 32>, n, block, 0, occ, stream, S, o,
                  d, n, iters, t_out, nit_out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K10a. flags: the VARIANTS entry as bits (fetch 1, prefetch 2, slab 4,
// reduce 8, prim 16, count 32; probes/ablate_walker.py::variant_flags);
// group 1 or 32 (n % group == 0, block % 32 == 0 for 32). out: (2, n) f32.
extern "C" int walk_ablate(const float* rows, int num_rows, const float* o,
                           const float* d, int n, int iters, int flags, int group,
                           int block, float* out, int* occ, void* stream) {
#define ABLATE_CASE(f)                                                          \
  case f:                                                                       \
    return ablate_group<f>(group, rows, num_rows, o, d, n, iters, block, out,   \
                           occ, stream);
  switch (flags) {  // the eleven VARIANTS of tools/ablate_walker.py:210
    ABLATE_CASE(63)  // full
    ABLATE_CASE(31)  // nocount
    ABLATE_CASE(55)  // noreduce
    ABLATE_CASE(47)  // noprim
    ABLATE_CASE(59)  // noslab
    ABLATE_CASE(61)  // noprefetch
    ABLATE_CASE(62)  // nofetch
    ABLATE_CASE(3)   // onlyfetch
    ABLATE_CASE(2)   // onlyloop (prefetch is moot without fetch)
    ABLATE_CASE(54)  // nofetch_noreduce
    ABLATE_CASE(39)  // noprim_noreduce
  }
#undef ABLATE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// K10b. row_w 32 or 16 (rows then holds make_w16_scene's table); test 0
// makes every prim row miss; group 1 or 32; iters >= 1 trips, each over
// other rays, the last over ray i. t_out, nit_out: (n,) f32.
extern "C" int walk_isolate(SCENE_ARGS, int row_w, int test, int group, int iters,
                            const float* o, const float* d, int n, int block,
                            float* t_out, float* nit_out, int* occ, void* stream) {
  const Scene S = SCENE_CALL;
#define ISOLATE(w, t)                                                           \
  return isolate_group<w, t>(group, S, o, d, n, iters, block, t_out, nit_out, occ, \
                             stream)
  if (row_w == 32) {
    if (test) ISOLATE(32, true);
    ISOLATE(32, false);
  }
  if (row_w == 16) {
    if (test) ISOLATE(16, true);
    ISOLATE(16, false);
  }
#undef ISOLATE
  return static_cast<int>(cudaErrorInvalidValue);
}

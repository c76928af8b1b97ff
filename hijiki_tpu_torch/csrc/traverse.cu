// K6: the trace-row walk for Hopper (sm_90a), closest hit or any hit.
//
// Replaces _traverse_kernel (hijiki_tpu/ops/pallas_traverse.py:41), which
// traverse_packets launches. The sync and wavefront drivers reach it through
// intersect_rows/occluded_rows and intersect_packets/occluded_packets
// (hijiki_tpu_torch/ops/intersect.py, ops/pallas_traverse.py). The plain
// PyTorch twin of every line below is ops/pallas_traverse.py::traverse_plain.
//
// Inputs: rays o, d (N, 3) f32 row-major, tmin, tmax (N,) f32; the classic
// (R, 32) f32 trace rows (scene/compile.py::build_trace_rows: interior rows
// kind -1, sphere/quad/triangle rows kind 0/1/2), 16-byte aligned. Output:
// (7, N) f32, channels [best_t, slot+1 (0 = miss), u, v, tag, midx, rows
// visited].
//
// The walk of one ray: stackless from row 0: an interior row slab-tests its
// box and goes to cur+1 or to the exit in column 10; a prim row runs the
// unified test, accepts when t lies in [tmin, best_t] and t < best_t, and
// exits. best_t starts at the ray's own tmax. Any-hit stops at the first
// accept, in one of two modes: strict (t < tmax, the Pallas kernel's;
// traverse_packets/occluded_packets) or inclusive (the prim test's own
// t <= tmax, as JAX's occluded_rows and intersect_unified accept;
// occluded_rows). The slab test stays strict (t0 < best_t) in both, as in
// both JAX walks. A ray with tmax < tmin (or a NaN bound) can accept nothing:
// it writes its miss (best_t = tmax, the rest 0) before it reads o or d;
// callers mark inactive lanes that way (tmax = -3e38). The TPU kernel walked
// 128-ray packets because Mosaic has no per-lane gather; a packet's hits are
// the same per ray. The row step is walk.cuh's (row.cuh): a row's columns
// 0-11 as three float4 loads, the slab test on min.NaN/max.NaN; the plane
// normal is the inline product of the row's edges, as the Pallas kernel
// computes it (columns 29-31 hold the same f32 product, but reading them in
// one more float4 read 2-9% slower on each recorded call).
//
// Written apart from the megakernel's walk(): that walk is bound to the
// megakernel's scene (octant table sets, the analytic triangle-only mode)
// and its entry rules (best_t from kBig, skip at tmax < 0), which K1-K5's
// bit-equality with their twin rests on; K6 is the Pallas kernel's contract
// on one classic table. The row primitives are shared.
//
// Design: one thread a lane, 128 threads a block. A lane that can accept
// nothing (tmax < tmin, a NaN bound, no rows) writes its miss first and
// returns before it reads o or d or divides. Packing the walking rays into
// full warps (a classify pass that queues them, then persistent warps that
// walk the queue 32 at a time) read 18-60% slower than this launch on each
// recorded call of a sync sweep, late bounces included (PERF.md §6): a
// launch lasts as long as its longest ray's chain of row loads, which
// packing cannot shorten, while it serializes the dead lanes' pass before
// the walk and packs rays that diverge into each warp.
//
// What bounds it: the walk is a chain of dependent loads (each row's exit
// pointer decides the next row), so a launch takes at least its longest
// ray's rows times the latency of a step; at late bounces, where a few
// rays walk among 1M lanes, that chain and the dead lanes' output bytes
// are the launch. The threads of a warp walk different rows (divergence);
// the table (1.2 MB for the meshbox) stays in L2. The row step is 41 SASS
// instructions for an interior row (76 before it took row.cuh's form).
// PERF.md §6 has the measured times beside the bound.
//
// Numerics: built with --fmad=false, so every a*b+c rounds twice as the
// twin's separate torch ops do; IEEE division and sqrtf; min/max propagate
// NaN like torch.minimum/maximum where a value is kept.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row.cuh"

namespace {

constexpr int kOut = 7;
constexpr int kThreads = 128;

// a lane that can accept nothing: tmax and a miss, 0 rows visited
__device__ __forceinline__ void write_miss(float* __restrict__ out, int n, int i,
                                           float tmax) {
  out[i] = tmax;
#pragma unroll
  for (int c = 1; c < kOut; ++c) out[static_cast<size_t>(c) * n + i] = 0.0f;
}

// the walk of ray i, which can accept something (tmax >= tmin, rows > 0)
template <bool kAnyHit, bool kInclusive>
__device__ __forceinline__ void walk_ray(const float* __restrict__ rows,
                                         int num_rows, const float* __restrict__ o,
                                         const float* __restrict__ d, float tmin,
                                         float tmax, int i, int n,
                                         float* __restrict__ out) {
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float tox = -ox * ix, toy = -oy * iy, toz = -oz * iz;
  float best = tmax, slot1 = 0.0f, bu = 0.0f, bv = 0.0f, btag = 0.0f,
        bmidx = 0.0f, nit = 0.0f;
  int cur = 0;
  while (cur < num_rows) {
    const float* r = rows + static_cast<size_t>(cur) * kRowW;
    const float4 c0 = row4(r, 0), c1 = row4(r, 4), c2 = row4(r, 8);
    nit = nit + 1.0f;
    const float kind = c2.y;
    const int nexit = static_cast<int>(c2.z);
    if (!(kind >= 0.0f)) {  // interior row: slab test on its box
      const float ax = c0.x * ix + tox, bx = c0.w * ix + tox;
      const float ay = c0.y * iy + toy, by = c1.x * iy + toy;
      const float az = c0.z * iz + toz, bz = c1.y * iz + toz;
      const float t0 = nan_max(nan_max(nan_min(ax, bx), nan_min(ay, by)), nan_min(az, bz));
      const float t1 = nan_min(nan_min(nan_max(ax, bx), nan_max(ay, by)), nan_max(az, bz));
      const bool slab = (t0 < t1 + kEps) && (t0 < best) && (t1 > tmin);
      cur = slab ? cur + 1 : nexit;
      continue;
    }
    const float rx = ox - c0.x, ry = oy - c0.y, rz = oz - c0.z;
    float pt, pu, pv;
    bool phit;
    if (kind == 0.0f) {  // sphere: center in columns 0-2, radius in 3
      const float rad = c0.w;
      const float sb = 2.0f * (dx * rx + dy * ry + dz * rz);
      const float sc = (rx * rx + ry * ry + rz * rz) - rad * rad;
      const float disc = sb * sb - 4.0f * sc;
      const float sq = sqrtf(jmax(disc, 0.0f));
      const float st0 = -0.5f * (sb + sq);
      const float st1 = -0.5f * (sb - sq);
      const bool ok0 = (tmin <= st0) && (st0 <= best);
      const bool ok1 = (tmin <= st1) && (st1 <= best);
      pt = ok0 ? st0 : st1;
      pu = 0.0f;
      pv = 0.0f;
      phit = (disc >= 0.0f) && (ok0 || ok1);
    } else {  // quad (kind 1) or triangle (kind 2): origin, edges e1, e2
      const float e1x = c0.w, e1y = c1.x, e1z = c1.y;
      const float e2x = c1.z, e2y = c1.w, e2z = c2.x;
      const float nx = e1y * e2z - e1z * e2y;
      const float ny = e1z * e2x - e1x * e2z;
      const float nz = e1x * e2y - e1y * e2x;
      const float qx = ry * dz - rz * dy;
      const float qy = rz * dx - rx * dz;
      const float qz = rx * dy - ry * dx;
      const float dd = 1.0f / (dx * nx + dy * ny + dz * nz);
      pu = -dd * (qx * e2x + qy * e2y + qz * e2z);
      pv = dd * (qx * e1x + qy * e1y + qz * e1z);
      pt = -dd * (nx * rx + ny * ry + nz * rz);
      const bool inside = (kind == 2.0f)
                              ? (pu >= 0.0f) && (pv >= 0.0f) && (pu + pv <= 1.0f)
                              : (pu >= 0.0f) && (pu <= 1.0f) && (pv >= 0.0f) &&
                                    (pv <= 1.0f);
      phit = inside && (tmin <= pt) && (pt <= best);
    }
    // with kInclusive (any hit only, so best is still tmax) phit alone
    // accepts: it already holds t <= tmax
    if (phit && (kInclusive || pt < best)) {
      const float4 c3 = row4(r, 12);
      best = pt;
      slot1 = c2.w + 1.0f;
      bu = pu;
      bv = pv;
      btag = c3.x;
      bmidx = c3.y;
      if (kAnyHit) break;
    }
    cur = nexit;
  }
  const float res[kOut] = {best, slot1, bu, bv, btag, bmidx, nit};
#pragma unroll
  for (int c = 0; c < kOut; ++c) out[static_cast<size_t>(c) * n + i] = res[c];
}

// one thread a lane; a lane that walks nothing returns before it reads o, d
template <bool kAnyHit, bool kInclusive>
__global__ void __launch_bounds__(kThreads)
    traverse_kernel(const float* __restrict__ rows, int num_rows,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmin_in,
                    const float* __restrict__ tmax_in, int n,
                    float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float tmin = tmin_in[i], tmax = tmax_in[i];
  if (!(tmax >= tmin) || num_rows <= 0) {
    write_miss(out, n, i, tmax);
    return;
  }
  walk_ray<kAnyHit, kInclusive>(rows, num_rows, o, d, tmin, tmax, i, n, out);
}

}  // namespace

extern "C" int traverse(const float* rows, int num_rows, const float* o,
                        const float* d, const float* tmin, const float* tmax,
                        int n, int any_hit, int inclusive, float* out,
                        cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  auto kernel = !any_hit ? traverse_kernel<false, false>
                : inclusive ? traverse_kernel<true, true>
                            : traverse_kernel<true, false>;
  kernel<<<blocks, kThreads, 0, stream>>>(rows, num_rows, o, d, tmin, tmax, n,
                                          out);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of K6 as built (closest hit): out[0] registers a
// thread, out[1] resident blocks an SM, out[2] threads a block, out[3] SMs,
// out[4] local-memory bytes a thread (spills included)
extern "C" int traverse_occupancy(int* out) {
  cudaFuncAttributes attr;
  int dev = 0;
  cudaError_t rc = cudaFuncGetAttributes(&attr, traverse_kernel<false, false>);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], traverse_kernel<false, false>, kThreads, 0);
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, dev);
  out[0] = attr.numRegs;
  out[2] = kThreads;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(rc);
}

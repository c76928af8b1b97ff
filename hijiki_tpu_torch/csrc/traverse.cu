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
// kind -1, sphere/quad/triangle rows kind 0/1/2). Output: (7, N) f32,
// channels [best_t, slot+1 (0 = miss), u, v, tag, midx, rows visited].
//
// Design: one thread per ray, 128 threads per block, a stackless walk from
// row 0: an interior row slab-tests its box and goes to cur+1 or to the exit
// in column 10; a prim row runs the unified test, accepts when t lies in
// [tmin, best_t] and t < best_t, and exits. best_t starts at the ray's own
// tmax. Any-hit stops at the first accept, in one of two modes: strict
// (t < tmax, the Pallas kernel's; traverse_packets/occluded_packets) or
// inclusive (the prim test's own t <= tmax, as JAX's occluded_rows and
// intersect_unified accept; occluded_rows). The slab test stays strict
// (t0 < best_t) in both, as in both JAX walks. A ray with tmax < tmin (or a NaN
// bound) can accept nothing and does not walk; callers mark inactive lanes
// that way (tmax = -3e38). The TPU kernel walked 128-ray packets because
// Mosaic has no per-lane gather; a packet's hits are the same per ray.
// The plane normal is computed inline from the row's edges, as the Pallas
// kernel does (columns 29-31 hold the same f32 product).
//
// Written standalone rather than sharing the megakernel's walk(): that walk
// is bound to the megakernel's scene (octant table sets, the analytic
// triangle-only mode) and its entry rules (best_t from kBig, skip at
// tmax < 0), which K1-K5's bit-equality with their twin rests on; K6 is the
// Pallas kernel's contract on one classic table.
//
// What bounds it: the walk is a chain of dependent loads (each row's exit
// pointer decides the next row) and the threads of a warp walk different
// rows (divergence); the table (1.2 MB for the meshbox) stays in L2. The
// arithmetic per row is ~20-50 f32 operations. This first version is simple
// and right, not tuned.
//
// Numerics: built with --fmad=false, so every a*b+c rounds twice as the
// twin's separate torch ops do; IEEE division and sqrtf; min/max propagate
// NaN like torch.minimum/maximum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 0x1.a36e2ep-14f;  // f32(1e-4)
constexpr int kRowW = 32;
constexpr int kOut = 7;
constexpr int kThreads = 128;

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fminf(a, b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fmaxf(a, b);
}

template <bool kAnyHit, bool kInclusive>
__global__ void __launch_bounds__(kThreads)
    traverse_kernel(const float* __restrict__ rows, int num_rows,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmin_in,
                    const float* __restrict__ tmax_in, int n,
                    float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tmin = tmin_in[i], tmax = tmax_in[i];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float tox = -ox * ix, toy = -oy * iy, toz = -oz * iz;
  float best = tmax, slot1 = 0.0f, bu = 0.0f, bv = 0.0f, btag = 0.0f,
        bmidx = 0.0f, nit = 0.0f;
  int cur = (tmax >= tmin) ? 0 : num_rows;
  while (cur < num_rows) {
    const float* r = rows + static_cast<size_t>(cur) * kRowW;
    nit = nit + 1.0f;
    const float kind = __ldg(r + 9);
    const int nexit = static_cast<int>(__ldg(r + 10));
    const float v0x = __ldg(r + 0), v0y = __ldg(r + 1), v0z = __ldg(r + 2);
    const float v1x = __ldg(r + 3), v1y = __ldg(r + 4), v1z = __ldg(r + 5);
    if (!(kind >= 0.0f)) {  // interior row: slab test on its box
      float ax = v0x * ix + tox, bx = v1x * ix + tox;
      float ay = v0y * iy + toy, by = v1y * iy + toy;
      float az = v0z * iz + toz, bz = v1z * iz + toz;
      float t0 = jmax(jmax(jmin(ax, bx), jmin(ay, by)), jmin(az, bz));
      float t1 = jmin(jmin(jmax(ax, bx), jmax(ay, by)), jmax(az, bz));
      bool slab = (t0 < t1 + kEps) && (t0 < best) && (t1 > tmin);
      cur = slab ? cur + 1 : nexit;
      continue;
    }
    const float rx = ox - v0x, ry = oy - v0y, rz = oz - v0z;
    float pt, pu, pv;
    bool phit;
    if (kind == 0.0f) {  // sphere: center v0, radius v1.x
      float sb = 2.0f * (dx * rx + dy * ry + dz * rz);
      float sc = (rx * rx + ry * ry + rz * rz) - v1x * v1x;
      float disc = sb * sb - 4.0f * sc;
      float sq = sqrtf(jmax(disc, 0.0f));
      float st0 = -0.5f * (sb + sq);
      float st1 = -0.5f * (sb - sq);
      bool ok0 = (tmin <= st0) && (st0 <= best);
      bool ok1 = (tmin <= st1) && (st1 <= best);
      pt = ok0 ? st0 : st1;
      pu = 0.0f;
      pv = 0.0f;
      phit = (disc >= 0.0f) && (ok0 || ok1);
    } else {  // quad (kind 1) or triangle (kind 2): origin v0, edges v1, v2
      const float v2x = __ldg(r + 6), v2y = __ldg(r + 7), v2z = __ldg(r + 8);
      float nx = v1y * v2z - v1z * v2y;
      float ny = v1z * v2x - v1x * v2z;
      float nz = v1x * v2y - v1y * v2x;
      float qx = ry * dz - rz * dy;
      float qy = rz * dx - rx * dz;
      float qz = rx * dy - ry * dx;
      float dd = 1.0f / (dx * nx + dy * ny + dz * nz);
      pu = -dd * (qx * v2x + qy * v2y + qz * v2z);
      pv = dd * (qx * v1x + qy * v1y + qz * v1z);
      pt = -dd * (nx * rx + ny * ry + nz * rz);
      bool inside = (kind == 2.0f)
                        ? (pu >= 0.0f) && (pv >= 0.0f) && (pu + pv <= 1.0f)
                        : (pu >= 0.0f) && (pu <= 1.0f) && (pv >= 0.0f) &&
                              (pv <= 1.0f);
      phit = inside && (tmin <= pt) && (pt <= best);
    }
    // with kInclusive (any hit only, so best is still tmax) phit alone
    // accepts: it already holds t <= tmax
    if (phit && (kInclusive || pt < best)) {
      best = pt;
      slot1 = __ldg(r + 11) + 1.0f;
      bu = pu;
      bv = pv;
      btag = __ldg(r + 12);
      bmidx = __ldg(r + 13);
      if (kAnyHit) break;
    }
    cur = nexit;
  }
  const float res[kOut] = {best, slot1, bu, bv, btag, bmidx, nit};
#pragma unroll
  for (int c = 0; c < kOut; ++c) out[static_cast<size_t>(c) * n + i] = res[c];
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

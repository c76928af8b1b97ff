// K3: the bilateral reconstruction stencil (R = 2) for Hopper (sm_90a).
//
// Replaces hijiki_tpu/render/pallas_reconstruct.py::_reconstruct_kernel.
// The plain twin is hijiki_tpu_torch/render/reconstruct.py::reconstruct_sweep
// (zero albedo), and this kernel computes what it computes: for each output
// pixel p and tap q = p + delta, |delta| <= 2,
//   w = wsp[delta] * exp(-2 |n(q) - n_center|^2)
// where wsp = [exp(gaussFac |delta + so - 0.5|^2) - curveOffset] is computed
// once per block and sweep with the twin's f32 operations (spatial_weights),
// with the reference's block-splat masks (no left/top spill; zero center
// normal on spill pixels), out-of-image taps masked (the Pallas roll wraps;
// its mask hides the wrap) and NaN contributions rejected. Taps accumulate
// in the Pallas kernel's order: dy outer, dx inner.
//
// The sample weight: 1 in reconstruct (kWeighted = false), so the fourth
// output channel accumulates w itself; reconstruct_weighted takes an
// (H, W) f32 weight (the Pallas kernel's sample_weight: 0 on the padding of
// a multi-device band's canvas), one plane that a launch's S sweeps share,
// and splats w (color wt, wt) as the twin does (wt = 1 gives the
// unweighted result bit for bit). The weight rides in the radiance tile's
// unused fourth word, and the parameter comes last, so the unweighted
// kernel compiles to the code it had before the weight existed.
//
// One launch takes S sweeps (a chained chunk's, up to kMaxSweeps; the C
// entry launches more in turn) and writes their deltas summed in sweep
// order, per pixel total = a_0, then total = total + a_s, as the renderer
// summed the per-sweep deltas with torch adds.
//
// Design: 32 x 8 threads a block, one output pixel a thread (2 and 4 rows
// a thread read slower: more registers, fewer resident warps). Per sweep
// the block stages the (H, W, 3) radiance and normals with a 2-pixel halo
// in shared memory as float4s (r, g, b, 0) (weighted: (r wt, g wt, b wt,
// wt)) and (nx, ny, nz, 0), so a tap
// reads two 128-bit words, and each input value is read from device memory
// about once. The block-splat geometry is hoisted out of the taps: each
// thread computes its five column and five row terms with two divisions
// (block_origin), packed into two 25-bit masks (tap valid: in the image and
// in the splat; center normal kept). A sweep's spatial gate (wsp >= 0) is
// one more 25-bit mask, so a tap tests bits.
//
// What bounds it: instruction issue, not memory. The first version read
// 4.8x its bytes bound in a stream at ~116 SASS instructions a tap (an
// integer division a tap, per-tap mask work, six 32-bit shared loads);
// this one issues ~50 a tap against 25 f32 operations (--fmad=false keeps
// every product and sum apart, expf is ~10 and the NaN rejection 5). PERF.md
// §6 has its time beside the bound.
//
// Numerics: built with --fmad=false; IEEE expf (no fast math), so the
// kernel and its twin differ only by expf ULPs (rtol 1e-5, atol 1e-6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 2;
constexpr int kD = 2 * kR + 1;
constexpr int kTaps = kD * kD;
constexpr int kTx = 32;
constexpr int kTy = 8;
constexpr int kMaxSweeps = 16;  // sweeps a launch
constexpr int kSw = kTx + 2 * kR;
constexpr int kSh = kTy + 2 * kR;

struct Offsets {
  float2 so[kMaxSweeps];  // each sweep's sample offset
};

// the origin of the B-block that holds p + d (p >= 0, |d| <= kR), given
// bp = p / B and rp = p - bp B: floordiv(p + d, B) = bp + floordiv(rp + d,
// B), and rp + d lies in [-2, B + 1], where four comparisons give it for
// every B >= 1
__device__ __forceinline__ int block_origin(int bp, int rp, int d, int B) {
  const int v = rp + d;
  return (bp + (v >= B) + (v >= 2 * B) - (v < 0) - (v < -B)) * B;
}

template <bool kWeighted>
__global__ void __launch_bounds__(kTx * kTy)
    reconstruct_kernel(const float* __restrict__ color,
                       const float* __restrict__ normal, Offsets offs, int S,
                       float gauss_fac, int H, int W, int B, int accumulate,
                       float* __restrict__ out, const float* __restrict__ weight) {
  __shared__ float4 rgb[kSh][kSw];
  __shared__ float4 nrm[kSh][kSw];
  __shared__ float taps[kMaxSweeps][kTaps];
  __shared__ unsigned gate[kMaxSweeps];
  const int tid = threadIdx.y * kTx + threadIdx.x;
  for (int k = tid; k < S * kTaps; k += kTx * kTy) {
    // the twin's spatial_weights, operation for operation in f32
    const int s = k / kTaps, t = k % kTaps;
    const float ox = static_cast<float>(t % kD - kR) + (offs.so[s].x - 0.5f);
    const float oy = static_cast<float>(t / kD - kR) + (offs.so[s].y - 0.5f);
    const float curve = expf(gauss_fac * static_cast<float>(kR * kR));
    taps[s][t] = expf(gauss_fac * (ox * ox + oy * oy)) - curve;
  }
  __syncthreads();
  if (tid < S) {
    unsigned g = 0;
    for (int t = 0; t < kTaps; ++t) g |= (taps[tid][t] >= 0.0f ? 1u : 0u) << t;
    gate[tid] = g;
  }

  // the block-splat geometry, hoisted: bit kD (dy + kR) + dx + kR of vmask
  // (the tap is in the image and in the splat) and of cmask (the center
  // normal is kept)
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const int bx = x / B, rx = x - bx * B, by = y / B, ry = y - by * B;
  unsigned colv = 0, colc = 0;  // bit dx + kR: the column terms
#pragma unroll
  for (int dx = -kR; dx <= kR; ++dx) {
    const int qx = x + dx, ox = block_origin(bx, rx, dx, B);
    const int dw = min(B, W - ox), lxq = x - ox;
    if (qx >= 0 && qx < W && lxq >= 0 && lxq < dw + kR) colv |= 1u << (dx + kR);
    if (lxq < dw) colc |= 1u << (dx + kR);
  }
  unsigned vmask = 0, cmask = 0;
#pragma unroll
  for (int dy = -kR; dy <= kR; ++dy) {
    const int qy = y + dy, oy = block_origin(by, ry, dy, B);
    const int dh = min(B, H - oy), lyq = y - oy;
    if (qy >= 0 && qy < H && lyq >= 0 && lyq < dh + kR) vmask |= colv << (kD * (dy + kR));
    if (lyq < dh) cmask |= colc << (kD * (dy + kR));
  }
  const bool here = x < W && y < H;
  if (!here) vmask = 0;

  float4 total;
  if (accumulate && here) total = reinterpret_cast<const float4*>(out)[static_cast<size_t>(y) * W + x];
  const size_t plane = static_cast<size_t>(H) * W * 3;
  const int cx = threadIdx.x + kR, cy = threadIdx.y + kR;
  for (int s = 0; s < S; ++s) {
    if (s) __syncthreads();  // the previous sweep's taps are read
    const float* cs = color + s * plane;
    const float* ns = normal + s * plane;
    for (int idx = tid; idx < kSh * kSw; idx += kTx * kTy) {
      const int ty = idx / kSw, tx = idx % kSw;
      const int gy = y0 + ty - kR, gx = x0 + tx - kR;
      float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f), n = c;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t px = static_cast<size_t>(gy) * W + gx, off = px * 3;
        if constexpr (kWeighted) {
          const float wt = weight[px];
          c = make_float4(cs[off] * wt, cs[off + 1] * wt, cs[off + 2] * wt, wt);
        } else {
          c = make_float4(cs[off], cs[off + 1], cs[off + 2], 0.0f);
        }
        n = make_float4(ns[off], ns[off + 1], ns[off + 2], 0.0f);
      }
      rgb[ty][tx] = c;
      nrm[ty][tx] = n;
    }
    __syncthreads();
    const unsigned valid = vmask & gate[s];
    const float4 nc = nrm[cy][cx];
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int dy = -kR; dy <= kR; ++dy) {
#pragma unroll
      for (int dx = -kR; dx <= kR; ++dx) {
        const int t = (dy + kR) * kD + (dx + kR);
        const float4 q = nrm[cy + dy][cx + dx];
        const bool center = (cmask >> t) & 1u;
        const float dnx = q.x - (center ? nc.x : 0.0f);
        const float dny = q.y - (center ? nc.y : 0.0f);
        const float dnz = q.z - (center ? nc.z : 0.0f);
        const float sq = dnx * dnx + dny * dny + dnz * dnz;
        const float w = taps[s][t] * expf(-(sq * 2.0f));
        const float4 p = rgb[cy + dy][cx + dx];
        const float c0 = w * p.x, c1 = w * p.y, c2 = w * p.z;
        const float c3 = kWeighted ? w * p.w : w;
        // short-circuit: the NaN tests only for a valid tap (branchless
        // bitwise tests took 8 more registers and read 3% slower)
        const bool ok = ((valid >> t) & 1u) && !(isnan(c0) || isnan(c1) || isnan(c2) || isnan(c3));
        a0 = ok ? a0 + c0 : a0;
        a1 = ok ? a1 + c1 : a1;
        a2 = ok ? a2 + c2 : a2;
        a3 = ok ? a3 + c3 : a3;
      }
    }
    if (s == 0 && !accumulate) {
      total = make_float4(a0, a1, a2, a3);
    } else {
      total.x = total.x + a0;
      total.y = total.y + a1;
      total.z = total.z + a2;
      total.w = total.w + a3;
    }
  }
  if (here) reinterpret_cast<float4*>(out)[static_cast<size_t>(y) * W + x] = total;
}

template <bool kWeighted>
int launch(const float* color, const float* normal, const float* weight,
           const float* offsets, int S, float gauss_fac, int H, int W, int B,
           float* out, void* stream) {
  const dim3 block(kTx, kTy);
  const dim3 grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy);
  const size_t plane = static_cast<size_t>(H) * W * 3;
  for (int s0 = 0; s0 < S; s0 += kMaxSweeps) {
    const int ns = S - s0 < kMaxSweeps ? S - s0 : kMaxSweeps;
    Offsets offs{};
    for (int k = 0; k < ns; ++k)
      offs.so[k] = make_float2(offsets[2 * (s0 + k)], offsets[2 * (s0 + k) + 1]);
    reconstruct_kernel<kWeighted><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        color + s0 * plane, normal + s0 * plane, offs, ns, gauss_fac, H, W, B, s0 > 0,
        out, weight);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}

}  // namespace

// color, normal: (S, H, W, 3) f32 device; offsets: the S sweeps' sample
// offsets, (S, 2) f32 on the host; gauss_fac: -1 / (2 stddev^2) as f32;
// out: (H, W, 4) f32 device, the S deltas summed in sweep order.
extern "C" int reconstruct(const float* color, const float* normal,
                           const float* offsets, int S, float gauss_fac, int H,
                           int W, int B, float* out, void* stream) {
  return launch<false>(color, normal, nullptr, offsets, S, gauss_fac, H, W, B, out,
                       stream);
}

// reconstruct with a sample weight: weight (H, W) f32 device, shared by the
// S sweeps.
extern "C" int reconstruct_weighted(const float* color, const float* normal,
                                    const float* weight, const float* offsets,
                                    int S, float gauss_fac, int H, int W, int B,
                                    float* out, void* stream) {
  return launch<true>(color, normal, weight, offsets, S, gauss_fac, H, W, B, out,
                      stream);
}

// What the card makes of K3 as built: out[0] registers a thread, out[1]
// resident blocks an SM, out[2] threads a block, out[3] SMs, out[4]
// local-memory bytes a thread (spills included)
extern "C" int reconstruct_occupancy(int* out) {
  cudaFuncAttributes attr;
  int dev = 0;
  cudaError_t rc = cudaFuncGetAttributes(&attr, reconstruct_kernel<false>);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], reconstruct_kernel<false>,
                                                       kTx * kTy, 0);
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, dev);
  out[0] = attr.numRegs;
  out[2] = kTx * kTy;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(rc);
}

// ALU issue and dtype probes for Hopper (sm_90a): K11b. Timing probes: the
// slope of their time over two trip counts (hijiki_tpu_torch/probes/
// timing.py) gives the cost of one trip of a loop that touches no memory.
//
// alu_issue replaces make_kernel (tools/vpu_issue_probe.py:40-68, pallas_call
// :75): four independent chains a, b, c, d per element; each trip adds
// f = f32(i) * 1e-9 and runs kK rounds of the tool's 14-op mix (mul/add,
// min, compare and select, max, abs); out = a + b + c + d. One thread per
// element (the tool's (8, 1024) block is the first 8192 elements).
//
// dtype_elementwise replaces _kernel (tools/vpu_dtype_probe.py:103-118,
// pallas_call :124): kChains independent chains x = (x * c1 + 0.125) * c2
// per element, c1 = 1.0009765625 and c2 = 0.9990234375 (exact in bf16);
// out = the chains' final values in f32, summed in chain order. Variants:
//   f32      one float a thread;
//   bf16     one __nv_bfloat16 a thread, every op rounded to bf16
//            (__hmul_rn / __hadd_rn: no contraction into an FMA);
//   bf16x2   two adjacent elements a thread as one __nv_bfloat162
//            (__hmul2_rn / __hadd2_rn), the packed form; it computes the
//            bf16 variant's values bit for bit.
//
// dtype_slab replaces _slab_kernel (tools/vpu_dtype_probe.py:38-87, pallas_call
// :91): the walker's slab-test mix in the probed type (6 multiply-adds of a
// row's broadcast columns, 10 min/max), the casts to f32, three compares,
// an `any` vote across the P lanes of a row, the select of best_t and the
// vote count in f32. One block of P threads a row; the vote is
// __syncthreads_or. The slab arithmetic depends on the inputs and the row
// only, never on the trip, so the compiler hoists it out of the loop and the
// probe would time a compare and a vote. An empty asm barrier on the inputs
// (asm volatile("" : "+f"(v))) does not stop it: the asm emits no PTX
// instruction, and ptxas hoists the arithmetic all the same (the loop held
// 10 instructions in the SASS). So, as the tool's body reads its row's
// columns from VMEM and casts them each trip, a trip reads the row's 6
// columns from shared memory with volatile loads (one broadcast LDS each)
// and converts them to the probed type: the 6 multiply-adds and the 10
// min/max then run every trip.
//
// min/max propagate NaN as torch.minimum/maximum do: min.NaN.f32 (one
// FMNMX) and __hmin_nan/__hmax_nan. Built with --fmad=false, so each a*b+c
// is two f32 instructions, as the plain versions' separate torch ops round.
// What bounds them: instruction issue, by design. The plain PyTorch
// versions are hijiki_tpu_torch/probes/vpu_issue_probe.py and
// vpu_dtype_probe.py. The trip loops are not unrolled (#pragma unroll 1), so
// one trip is one pass of the loop body in the SASS.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe.cuh"

namespace {

enum DtypeVariant { kF32 = 0, kBf16 = 1, kBf16x2 = 2 };

// ---------------------------------------------------------------- alu_issue --

template <int kK>
__global__ void alu_issue_kernel(const float* __restrict__ x, int n, int iters,
                                 float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float a = x[e];
  float b = a * 1.0001f + 0.25f;
  float c = a * 0.9999f - 0.125f;
  float d = a + 0.5f;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    const float f = static_cast<float>(i) * 1e-9f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      a = a * 1.000001f + f;
      b = nan_min(b + 0.75f, a);
      c = c > a ? c * 0.5f : c + 0.125f;
      d = d + c * 0.000001f;
      a = nan_max(a, 0.0f);
      b = b * 0.999999f;
      c = fabsf(c - b);
      d = nan_min(d, 8192.0f);
    }
  }
  out[e] = a + b + c + d;
}

// -------------------------------------------------------- dtype_elementwise --

template <int kChains>
__global__ void ew_f32_kernel(const float* __restrict__ x, int n, int iters,
                              float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float v[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) v[k] = x[static_cast<size_t>(k) * n + e];
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) v[k] = (v[k] * 1.0009765625f + 0.125f) * 0.9990234375f;
  }
  float acc = v[0];
#pragma unroll
  for (int k = 1; k < kChains; ++k) acc = acc + v[k];
  out[e] = acc;
}

template <int kChains>
__global__ void ew_bf16_kernel(const __nv_bfloat16* __restrict__ x, int n, int iters,
                               float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const __nv_bfloat16 c1 = __float2bfloat16_rn(1.0009765625f);
  const __nv_bfloat16 c0 = __float2bfloat16_rn(0.125f);
  const __nv_bfloat16 c2 = __float2bfloat16_rn(0.9990234375f);
  __nv_bfloat16 v[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) v[k] = x[static_cast<size_t>(k) * n + e];
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) v[k] = __hmul_rn(__hadd_rn(__hmul_rn(v[k], c1), c0), c2);
  }
  float acc = __bfloat162float(v[0]);
#pragma unroll
  for (int k = 1; k < kChains; ++k) acc = acc + __bfloat162float(v[k]);
  out[e] = acc;
}

// two adjacent elements a thread (n even)
template <int kChains>
__global__ void ew_bf16x2_kernel(const __nv_bfloat162* __restrict__ x, int n, int iters,
                                 float* __restrict__ out) {
  const int h = n / 2;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= h) return;
  const __nv_bfloat162 c1 = __float2bfloat162_rn(1.0009765625f);
  const __nv_bfloat162 c0 = __float2bfloat162_rn(0.125f);
  const __nv_bfloat162 c2 = __float2bfloat162_rn(0.9990234375f);
  __nv_bfloat162 v[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) v[k] = x[static_cast<size_t>(k) * h + e];
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k)
      v[k] = __hmul2_rn(__hadd2_rn(__hmul2_rn(v[k], c1), c0), c2);
  }
  float lo = __low2float(v[0]), hi = __high2float(v[0]);
#pragma unroll
  for (int k = 1; k < kChains; ++k) {
    lo = lo + __low2float(v[k]);
    hi = hi + __high2float(v[k]);
  }
  reinterpret_cast<float2*>(out)[e] = make_float2(lo, hi);
}

// --------------------------------------------------------------- dtype_slab --

// the probed type's arithmetic, each op rounded to the type
struct F32Ops {
  using T = float;
  static __device__ __forceinline__ T of(float v) { return v; }
  static __device__ __forceinline__ float f32(T v) { return v; }
  static __device__ __forceinline__ T mad(T a, T b, T c) { return a * b + c; }
  static __device__ __forceinline__ T mn(T a, T b) { return nan_min(a, b); }
  static __device__ __forceinline__ T mx(T a, T b) { return nan_max(a, b); }
};

struct Bf16Ops {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T of(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float f32(T v) { return __bfloat162float(v); }
  static __device__ __forceinline__ T mad(T a, T b, T c) {
    return __hadd_rn(__hmul_rn(a, b), c);
  }
  static __device__ __forceinline__ T mn(T a, T b) { return __hmin_nan(a, b); }
  static __device__ __forceinline__ T mx(T a, T b) { return __hmax_nan(a, b); }
};

// x: (6, rows, P) f32 (inv_d xyz, t_off xyz); row: (rows, 32) f32;
// out: (rows, P) f32. One block of P threads a row.
template <typename Ops>
__global__ void dtype_slab_kernel(const float* __restrict__ x,
                                  const float* __restrict__ row, int rows, int P,
                                  int iters, float* __restrict__ out) {
  using T = typename Ops::T;
  __shared__ float srow[6];
  const int r = blockIdx.x, p = threadIdx.x;
  const size_t plane = static_cast<size_t>(rows) * P;
  const size_t e = static_cast<size_t>(r) * P + p;
  if (p < 6) srow[p] = row[r * 32 + p];
  __syncthreads();
  const volatile float* vrow = srow;
  T in[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) in[k] = Ops::of(x[k * plane + e]);
  const float x0 = x[e];
  float acc = x[static_cast<size_t>(r) * P] * 0.0f;
  float best_t = x0 * 0.0f + 1e6f;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    T col[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) col[k] = Ops::of(vrow[k]);
    const T ax = Ops::mad(col[0], in[0], in[3]);
    const T bx = Ops::mad(col[3], in[0], in[3]);
    const T ay = Ops::mad(col[1], in[1], in[4]);
    const T by = Ops::mad(col[4], in[1], in[4]);
    const T az = Ops::mad(col[2], in[2], in[5]);
    const T bz = Ops::mad(col[5], in[2], in[5]);
    const T t0 = Ops::mx(Ops::mx(Ops::mn(ax, bx), Ops::mn(ay, by)), Ops::mn(az, bz));
    const T t1 = Ops::mn(Ops::mn(Ops::mx(ax, bx), Ops::mx(ay, by)), Ops::mx(az, bz));
    const float t0f = Ops::f32(t0), t1f = Ops::f32(t1);
    const bool slab = (t0f < t1f + 1e-4f) && (t0f < best_t) && (t1f > 1e-4f);
    const bool vote = __syncthreads_or(slab) != 0;
    best_t = slab ? best_t * 0.9999f : best_t;
    acc = acc + (vote ? 1.0f : 0.0f);
  }
  out[e] = acc + best_t;
}

template <int kChains>
int ew_launch(int variant, const void* x, int n, int iters, int block, float* out,
              int* occ, void* stream) {
  switch (variant) {
    case kF32:
      return launch(ew_f32_kernel<kChains>, n, block, 0, occ, stream,
                    static_cast<const float*>(x), n, iters, out);
    case kBf16:
      return launch(ew_bf16_kernel<kChains>, n, block, 0, occ, stream,
                    static_cast<const __nv_bfloat16*>(x), n, iters, out);
    case kBf16x2:
      return launch(ew_bf16x2_kernel<kChains>, n / 2, block, 0, occ, stream,
                    static_cast<const __nv_bfloat162*>(x), n, iters, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: (n,) f32; k: rounds a trip (1, 2, 4, 8 or 16); out: (n,) f32.
extern "C" int alu_issue(int k, const float* x, int n, int iters, int block, float* out,
                         int* occ, void* stream) {
  switch (k) {
    case 1: return launch(alu_issue_kernel<1>, n, block, 0, occ, stream, x, n, iters, out);
    case 2: return launch(alu_issue_kernel<2>, n, block, 0, occ, stream, x, n, iters, out);
    case 4: return launch(alu_issue_kernel<4>, n, block, 0, occ, stream, x, n, iters, out);
    case 8: return launch(alu_issue_kernel<8>, n, block, 0, occ, stream, x, n, iters, out);
    case 16: return launch(alu_issue_kernel<16>, n, block, 0, occ, stream, x, n, iters, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// variant: 0 f32, 1 bf16, 2 bf16x2; x: (chains, n) f32 or bf16; out: (n,) f32.
extern "C" int dtype_elementwise(int variant, int chains, const void* x, int n, int iters,
                                 int block, float* out, int* occ, void* stream) {
  switch (chains) {
    case 1: return ew_launch<1>(variant, x, n, iters, block, out, occ, stream);
    case 2: return ew_launch<2>(variant, x, n, iters, block, out, occ, stream);
    case 4: return ew_launch<4>(variant, x, n, iters, block, out, occ, stream);
    case 8: return ew_launch<8>(variant, x, n, iters, block, out, occ, stream);
    case 16: return ew_launch<16>(variant, x, n, iters, block, out, occ, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// variant: 0 f32, 1 bf16; x: (6, rows, P) f32; row: (rows, 32) f32;
// out: (rows, P) f32; P <= 1024 threads a block.
extern "C" int dtype_slab(int variant, const float* x, const float* row, int rows, int P,
                          int iters, float* out, int* occ, void* stream) {
  if (variant == kF32)
    return launch(dtype_slab_kernel<F32Ops>, rows * P, P, 0, occ, stream, x, row, rows, P,
                  iters, out);
  if (variant == kBf16)
    return launch(dtype_slab_kernel<Bf16Ops>, rows * P, P, 0, occ, stream, x, row, rows, P,
                  iters, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// vote count in f32. The TPU held a row's lanes in one vreg set and reduced
// them in registers; here a thread holds kL lanes of its row (lane t + j
// 32W for j < kL, W = ceil(P / 32 kL) warps a row), ORs their votes, and the
// row's `any` is one __any_sync where the row is one warp, else one
// bar.red.or of the row's W warps on a named barrier of their own (at most
// kSlabMaxWarps: no barrier of a 1,024-thread block). Rows of one or two
// warps share 128-thread blocks, each on its own barrier. The split (kL,
// W) is the wrapper's (vpu_dtype_probe.slab_split, from the card's
// measurements: PERF.md §6). So a thread pays the trip's shared loads,
// vote, count and loop once for kL lanes: with one lane a thread they were
// 12 of a trip's 40 instructions. Lanes past P (where 32 W kL > P) start
// at best_t = -inf, so their compares never pass and they never vote.
// The slab arithmetic depends on the inputs and the row only, never on the
// trip, so the compiler hoists it out of the loop and the probe would time
// a compare and a vote. An empty asm barrier on the inputs (asm
// volatile("" : "+f"(v))) does not stop it: the asm emits no PTX
// instruction, and ptxas hoists the arithmetic all the same (the loop held
// 10 instructions in the SASS). So, as the tool's body reads its row's
// columns from VMEM and casts them each trip, a trip reads the row's 6
// columns from shared memory with volatile loads (one broadcast LDS each)
// and converts them to the probed type: the 6 multiply-adds and the 10
// min/max of every lane then run every trip
// (vpu_dtype_probe.check_slab_loops holds the SASS trip loop to that).
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

constexpr int kSlabMaxWarps = 8;  // warps a row at most
constexpr int kSlabBlock = 128;    // threads a block of rows of one or two warps

// The OR of `p` over the `threads` threads (whole warps) of named barrier
// `id` (1-15): bar.red.or.pred, the reduction __syncthreads_or makes on
// barrier 0, on the barrier of one row's warps only.
__device__ __forceinline__ bool row_or(bool p, int id, int threads) {
  unsigned r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\tsetp.ne.u32 p, %1, 0;\n\t"
      "bar.red.or.pred q, %2, %3, p;\n\tselp.u32 %0, 1, 0, q;\n\t}"
      : "=r"(r)
      : "r"(static_cast<unsigned>(p)), "r"(id), "r"(threads)
      : "memory");
  return r != 0;
}

// x: (6, rows, P) f32 (inv_d xyz, t_off xyz); row: (rows, 32) f32;
// out: (rows, P) f32. W warps a row, kL lanes a thread; kOneWarp: W = 1.
template <typename Ops, int kL, bool kOneWarp>
__global__ void __launch_bounds__(kSlabMaxWarps * 32)
    dtype_slab_kernel(const float* __restrict__ x, const float* __restrict__ row, int rows,
                      int P, int warps, int iters, float* __restrict__ out) {
  using T = typename Ops::T;
  __shared__ float srow[kSlabBlock / 32][6];
  const int span = 32 * warps;  // threads a row
  const int g = threadIdx.x / span, t = threadIdx.x - g * span;
  const int r = blockIdx.x * (blockDim.x / span) + g;
  if (t < 6 && r < rows) srow[g][t] = row[r * 32 + t];
  __syncthreads();
  if (r >= rows) return;  // whole warps: the row's barrier goes unused
  const volatile float* vrow = srow[g];
  const size_t plane = static_cast<size_t>(rows) * P;
  const size_t e0 = static_cast<size_t>(r) * P;
  T in[kL][6];
  float best_t[kL];
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    const int p = t + j * span;
#pragma unroll
    for (int k = 0; k < 6; ++k) in[j][k] = Ops::of(p < P ? x[k * plane + e0 + p] : 0.0f);
    best_t[j] = p < P ? x[e0 + p] * 0.0f + 1e6f : __int_as_float(0xff800000);  // -inf
  }
  float acc = x[e0] * 0.0f;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    T col[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) col[k] = Ops::of(vrow[k]);
    bool any = false;
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const T ax = Ops::mad(col[0], in[j][0], in[j][3]);
      const T bx = Ops::mad(col[3], in[j][0], in[j][3]);
      const T ay = Ops::mad(col[1], in[j][1], in[j][4]);
      const T by = Ops::mad(col[4], in[j][1], in[j][4]);
      const T az = Ops::mad(col[2], in[j][2], in[j][5]);
      const T bz = Ops::mad(col[5], in[j][2], in[j][5]);
      const T t0 = Ops::mx(Ops::mx(Ops::mn(ax, bx), Ops::mn(ay, by)), Ops::mn(az, bz));
      const T t1 = Ops::mn(Ops::mn(Ops::mx(ax, bx), Ops::mx(ay, by)), Ops::mx(az, bz));
      const float t0f = Ops::f32(t0), t1f = Ops::f32(t1);
      const bool slab = (t0f < t1f + 1e-4f) && (t0f < best_t[j]) && (t1f > 1e-4f);
      best_t[j] = slab ? best_t[j] * 0.9999f : best_t[j];
      any |= slab;
    }
    const bool vote = kOneWarp ? __any_sync(0xffffffffu, any) : row_or(any, 1 + g, span);
    acc = acc + (vote ? 1.0f : 0.0f);
  }
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    const int p = t + j * span;
    if (p < P) out[e0 + p] = acc + best_t[j];
  }
}

// rows of `warps` warps in blocks of kSlabBlock threads where that holds
// whole rows, else a block a row
template <typename Ops, int kL>
int slab_launch(const float* x, const float* row, int rows, int P, int warps, int iters,
                float* out, int* occ, void* stream) {
  const int span = 32 * warps;
  const int block = kSlabBlock % span == 0 ? kSlabBlock : span;
  const int threads = (rows + block / span - 1) / (block / span) * block;
  if (warps == 1)
    return launch(dtype_slab_kernel<Ops, kL, true>, threads, block, 0, occ, stream, x, row,
                  rows, P, warps, iters, out);
  return launch(dtype_slab_kernel<Ops, kL, false>, threads, block, 0, occ, stream, x, row, rows,
                P, warps, iters, out);
}

template <int kL>
int slab_variant(int variant, const float* x, const float* row, int rows, int P, int warps,
                 int iters, float* out, int* occ, void* stream) {
  if (variant == kF32)
    return slab_launch<F32Ops, kL>(x, row, rows, P, warps, iters, out, occ, stream);
  if (variant == kBf16)
    return slab_launch<Bf16Ops, kL>(x, row, rows, P, warps, iters, out, occ, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
// out: (rows, P) f32; P a multiple of 32 up to 1024; lanes a thread 1, 2, 4,
// 8, 16 or 32, at most kSlabMaxWarps warps a row.
extern "C" int dtype_slab(int variant, const float* x, const float* row, int rows, int P,
                          int iters, int lanes, float* out, int* occ, void* stream) {
  if (P < 32 || P > 1024 || P % 32 || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = (P / 32 + lanes - 1) / lanes;
  if (warps > kSlabMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  switch (lanes) {
    case 1: return slab_variant<1>(variant, x, row, rows, P, warps, iters, out, occ, stream);
    case 2: return slab_variant<2>(variant, x, row, rows, P, warps, iters, out, occ, stream);
    case 4: return slab_variant<4>(variant, x, row, rows, P, warps, iters, out, occ, stream);
    case 8: return slab_variant<8>(variant, x, row, rows, P, warps, iters, out, occ, stream);
    case 16: return slab_variant<16>(variant, x, row, rows, P, warps, iters, out, occ, stream);
    case 32: return slab_variant<32>(variant, x, row, rows, P, warps, iters, out, occ, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

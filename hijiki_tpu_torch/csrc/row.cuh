// The row step's primitives, shared by every walk of the trace rows: the
// megakernel's and the walk probe's (walk.cuh) and K6's (traverse.cu).
//
// A row's columns come in as 128-bit loads (row4: the table is 16-byte
// aligned, which every wrapper checks). The slab test's min/max are single
// min.NaN/max.NaN instructions (nan_min/nan_max): their results only feed
// comparisons, which a NaN fails whatever its bits, so they decide as
// jmin/jmax do; jmin/jmax (torch.minimum/maximum, NaN as qnan()) stay
// wherever a value is kept.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 0x1.a36e2ep-14f;  // f32(1e-4)
constexpr int kRowW = 32;                // floats a trace row

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fminf(a, b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fmaxf(a, b);
}
// one FMNMX each (min.NaN/max.NaN; probe_alu.cu's bodies use them too). A
// NaN operand gives PTX's canonical NaN, whose bits need not be qnan()'s, so
// the render kernels take them only for values that feed comparisons
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
// four consecutive columns of a row (16-byte aligned), a read-only load
__device__ __forceinline__ float4 row4(const float* r, int col) {
  return __ldg(reinterpret_cast<const float4*>(r + col));
}

}  // namespace

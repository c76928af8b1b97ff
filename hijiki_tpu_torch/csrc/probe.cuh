// What the probe kernels (probe_walk.cu, probe_latency.cu) share: walk.cuh's
// NaN-propagating min/max and group vote, the group's first lane, and one
// launch helper that also answers the occupancy query of the slope harness
// (hijiki_tpu_torch/probes/__init__.py::call).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "walk.cuh"

namespace {

// the value of a group's first thread: the thread's own (kG = 1) or lane 0's
template <int kG, typename T>
__device__ __forceinline__ T group_first(T x) {
  if constexpr (kG == 1) return x;
  else return static_cast<T>(__shfl_sync(kFull, x, 0));
}

// Launch `kernel` on `threads` threads in blocks of `block` with `smem` bytes
// of dynamic shared memory (opting in past 48 KB), or, with `occ` non-null,
// only write the blocks of that shape one SM holds at once.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int threads, int block, size_t smem, int* occ,
           void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  if (occ != nullptr)
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel, block, smem));
  kernel<<<(threads + block - 1) / block, block, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

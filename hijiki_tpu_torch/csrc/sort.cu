// K8 on the card: the standalone launch of the block sort (sort.cuh), the
// counterpart of the harness that runs hijiki_tpu/ops/pallas_sort.py::
// sort_tile_by_key alone on one (8,128) tile (tests/test_megakernel.py:337).
//
// One block of 1024 threads per tile of 1024 lanes (the TPU tile, so the
// permutation is the TPU kernel's): the block sorts the tile's keys, then
// moves each of the C int32 payload channels (f32/u32 ride as their bits)
// through the permutation: a coalesced load into shared memory, a gather
// from shared memory, a coalesced store.
//
// What bounds it: bytes. Each key and payload word is read once and written
// once; the 55 stages of the sort run from registers and shared memory.

#include <cuda_runtime.h>

#include "sort.cuh"

namespace {

constexpr int kTile = 1024;

__global__ void __launch_bounds__(kTile)
    sort_tiles_kernel(const int* key, const int* payload, int T, int C,
                      int* key_out, int* payload_out) {
  __shared__ hijiki_sort::Scratch<kTile> scratch;
  __shared__ int stage[kTile];
  const int i = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  int k = key[base + i];
  const int src = hijiki_sort::block_sort<kTile>(k, scratch);
  key_out[base + i] = k;
  for (int c = 0; c < C; ++c) {
    const size_t off = (static_cast<size_t>(c) * T + blockIdx.x) * kTile;
    stage[i] = payload[off + i];
    __syncthreads();
    payload_out[off + i] = stage[src];
    __syncthreads();
  }
}

}  // namespace

// key (T, 1024) int32, payload (C, T, 1024) int32 -> key_out, payload_out
extern "C" int sort_tiles(const int* key, const int* payload, int T, int C,
                          int* key_out, int* payload_out, void* stream) {
  if (T > 0)
    sort_tiles_kernel<<<T, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        key, payload, T, C, key_out, payload_out);
  return static_cast<int>(cudaGetLastError());
}

// Block-wide bitonic sort of a tile of int32 keys, one key per thread
// (sm_90a). K7 on the card: the counterpart of
// hijiki_tpu/ops/pallas_sort.py::sort_tile_by_key.
//
// The network is the TPU kernel's, stage for stage: k = 2, 4, ..., kTile
// and j = k/2 down to 1 (55 compare-exchange stages at 1024 lanes). Lane i
// pairs with lane i ^ j; the pair is ascending where the k-bit of i is 0;
// the keep rule is pair-consistent on ties,
//   keep_self = (bit0 & ~bigger) | (~bit0 & (bigger | equal)),
//   swap      = ascending ^ keep_self,
// so equal keys land in one determined order (not a stable one) and the
// permutation is the TPU kernel's bit for bit. The plain PyTorch version is
// hijiki_tpu_torch/ops/sort.py::bitonic_order.
//
// Where the TPU rolled whole (8,128) vregs twice per stage, a thread here
// holds its lane's (key, source lane) pair in registers. Stages with
// j < 32 exchange inside the warp (__shfl_xor_sync, no barrier); the others
// go through shared memory, double-buffered so one __syncthreads() per stage
// is enough (15 of the 55 stages at 1024 lanes). The sort returns the
// source lane of the key each thread ends with: the caller moves its own
// payload through that permutation.
//
// What bounds it: barrier latency (a stage is a few instructions between
// two barriers); it touches no device memory.

#pragma once

#include <cuda_runtime.h>

namespace hijiki_sort {

// shared memory of one block's sort: two buffers of (key, source lane)
template <int kTile>
struct Scratch {
  int2 buf[2][kTile];
};

// whether lane i takes its partner's pair at stage (k, j)
__device__ __forceinline__ bool take_partner(int i, int k, int j, int key, int pkey) {
  const bool bit0 = (i & j) == 0;
  const bool ascending = (i & k) == 0;
  const bool bigger = key > pkey;
  const bool equal = key == pkey;
  const bool keep_self = (bit0 && !bigger) || (!bit0 && (bigger || equal));
  return ascending != keep_self;
}

// Sort the block's kTile keys ascending (thread i holds flat lane i; every
// thread of the block must call it). On return `key` is the sorted key at
// lane threadIdx.x; the result is the lane it came from. The caller must
// pass a __syncthreads() before the next call reuses `s`.
template <int kTile>
__device__ __forceinline__ int block_sort(int& key, Scratch<kTile>& s) {
  static_assert(kTile >= 32 && (kTile & (kTile - 1)) == 0,
                "the tile is a power of two of at least one warp");
  const int i = threadIdx.x;
  int src = i;
  int b = 0;
#pragma unroll 1
  for (int k = 2; k <= kTile; k <<= 1) {
#pragma unroll 1
    for (int j = k >> 1; j >= 1; j >>= 1) {
      int pkey, psrc;
      if (j >= 32) {
        s.buf[b][i] = make_int2(key, src);
        __syncthreads();
        const int2 q = s.buf[b][i ^ j];
        pkey = q.x;
        psrc = q.y;
        b ^= 1;  // the next shared stage writes the other buffer
      } else {
        pkey = __shfl_xor_sync(0xffffffffu, key, j);
        psrc = __shfl_xor_sync(0xffffffffu, src, j);
      }
      if (take_partner(i, k, j, key, pkey)) {
        key = pkey;
        src = psrc;
      }
    }
  }
  return src;
}

}  // namespace hijiki_sort

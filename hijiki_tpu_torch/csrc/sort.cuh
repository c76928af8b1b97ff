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
// payload through that permutation. Both sorts are unrolled in full, so a
// stage keeps only its exchange, the compare and the select, with j, k and
// the buffer known at compile time.
//
// What bounds it: barrier latency and issue (a stage is a few instructions,
// 15 of them behind a barrier); it touches no device memory. block_sort
// is K8's; block_sort_packed (below) is the same network on one packed word
// a lane, for keys that leave room for the payload's bits (the lane-sorted
// megakernels' keys, at most 2^20).

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
#pragma unroll
  for (int k = 2; k <= kTile; k <<= 1) {
#pragma unroll
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

// shared memory of one block's packed sort: two buffers of packed words
template <int kTile>
struct PackedScratch {
  int buf[2][kTile];
};

// log2 of a power of two
__host__ __device__ constexpr int log2_exact(int x) { return x == 1 ? 0 : 1 + log2_exact(x >> 1); }

// The same network on keys in [0, kMaxKey] with a payload below kTile
// packed into one word, (key << log2(kTile)) | payload: an in-warp stage
// shuffles one word where block_sort shuffles two, a shared stage stores
// one int. The compare reads the key field alone, so the tie rule, and
// with it the permutation, is block_sort's bit for bit. On return `key` is
// the sorted key at lane threadIdx.x; the result is the payload that came
// with it (a thread passing its own lane gets block_sort's source lane).
// The same barrier rule as block_sort. Unrolled in full: the stages are a
// chain of dependent shuffles, and a block that sorts every pass for a few
// live paths waits on that chain, so each stage keeps only its shuffle (or
// shared exchange), the compare and the select, with j, k and the buffer
// known at compile time.
template <int kTile, int kMaxKey>
__device__ __forceinline__ int block_sort_packed(int& key, int payload,
                                                 PackedScratch<kTile>& s) {
  static_assert(kTile >= 32 && (kTile & (kTile - 1)) == 0,
                "the tile is a power of two of at least one warp");
  constexpr int kBits = log2_exact(kTile);
  static_assert(kMaxKey >= 0 && kMaxKey <= (0x7fffffff - (kTile - 1)) >> kBits,
                "a key and a payload fit one non-negative int32");
  // the lane, read where the sort runs: a plain threadIdx.x lets the
  // compiler hoist the unrolled stages' lane masks out of the caller's
  // loop, and hold them in registers across its bounce (a spill at 80)
  int i;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(i));
  int v = (key << kBits) | payload;
  int b = 0;
#pragma unroll
  for (int lk = 1; lk <= kBits; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      int pv;
      if (j >= 32) {
        s.buf[b][i] = v;
        __syncthreads();
        pv = s.buf[b][i ^ j];
        b ^= 1;  // the next shared stage writes the other buffer
      } else {
        pv = __shfl_xor_sync(0xffffffffu, v, j);
      }
      if (take_partner(i, k, j, v >> kBits, pv >> kBits)) v = pv;
    }
  }
  key = v >> kBits;
  return v & (kTile - 1);
}

}  // namespace hijiki_sort

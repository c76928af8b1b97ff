// K8 on the card: the standalone launch of the block sort (sort.cuh), the
// counterpart of the harness that runs hijiki_tpu/ops/pallas_sort.py::
// sort_tile_by_key alone on one (8,128) tile (tests/test_megakernel.py:337).
//
// One block of 1024 threads per tile of 1024 lanes (the TPU tile, so the
// permutation is the TPU kernel's): the block sorts the tile's keys, then
// moves each of the C int32 payload channels (f32/u32 ride as their bits)
// through the permutation.
//
// What bounds it: bytes. Each key and payload word is read once and written
// once (at 1,024 tiles x 31 channels, 268 MB: 0.080 ms at 3.35 TB/s); the
// 55 stages of the sort run from registers and shared memory. Keeping the
// memory busy takes ~25 KB in flight an SM (3.35 TB/s times ~1 us of loaded
// latency over 132 SMs), and only 2 blocks of 1024 threads fit an SM, so a
// thread loading one word of one channel before each barrier (8 KB an SM)
// paid a load latency a channel, after the whole sort. The design:
// * each channel's tile row is one contiguous 4 KB run of the payload
//   ((C, T, 1024) layout); a batch of kBatch channels is copied into shared
//   memory with cp.async (16 bytes a thread, coalesced, no register held),
//   into a ring of kRing buffers: kRing * kBatch channels (64 KB a block) are
//   in flight at once, and the first kRing batches are issued before the
//   sort, so their latency hides behind the network;
// * a batch waits on its copies (cp.async.wait_group) and one barrier, then
//   each thread gathers 4 consecutive lanes of one channel from shared
//   memory (their source lanes read from the sort's result in shared memory)
//   and stores them as one 16-byte word (coalesced); a second barrier frees
//   the buffer for the batch kRing later.
// cp.async rather than the bulk copy (cp.async.bulk with an mbarrier): the
// copies come from all threads of the block in one instruction each, need
// no barrier object of their own, and 84 KB of shared memory a block keeps
// 2 blocks (64 warps) an SM, where a persistent block holding a tile's 31
// channels (124 KB) would hold one. The network (sort.cuh) runs unrolled.
// On the H100 (PERF.md) the batches are the lever: one channel a batch and
// one batch in flight reads as slow as the barrier a channel did; issuing
// the first batches before the sort reads the same as after it.

#include <cuda_runtime.h>

#include "sort.cuh"

namespace {

constexpr int kTile = 1024;       // lanes a tile, threads a block
constexpr int kQuads = kTile / 4;  // 16-byte pieces of one channel's tile row
constexpr int kBatch = 4;          // channels a batch (one piece a thread)
constexpr int kRing = 4;           // batches in flight (shared buffers)

struct Shared {
  int stage[kRing][kBatch][kTile];
  hijiki_sort::Scratch<kTile> scratch;
  int src[kTile];  // the source lane of each sorted lane
};

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Issue the copies of batch b (channels b * kBatch on, fewer past C) into
// its ring buffer, and commit them as one group: every thread commits one
// group a batch, an empty one past C, so that kRing - 1 groups pending
// always means the oldest batch has landed.
__device__ __forceinline__ void issue(Shared& sh, const int* payload, int T, int C,
                                      int tile, int b) {
  const int c0 = b * kBatch;
  const int nc = C - c0 < kBatch ? C - c0 : kBatch;
  int* buf = &sh.stage[b % kRing][0][0];
  for (int q = threadIdx.x; q < nc * kQuads; q += kTile) {
    const int c = q / kQuads, l = (q % kQuads) * 4;
    copy16_async(buf + c * kTile + l, payload + (static_cast<size_t>(c0 + c) * T + tile) * kTile + l);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kTile, 2)
    sort_tiles_kernel(const int* key, const int* payload, int T, int C,
                      int* key_out, int* payload_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  const int i = threadIdx.x;
  const int tile = blockIdx.x;
  const size_t base = static_cast<size_t>(tile) * kTile;
  int k = key[base + i];
  for (int b = 0; b < kRing; ++b) issue(sh, payload, T, C, tile, b);  // in flight during the sort
  const int src = hijiki_sort::block_sort<kTile>(k, sh.scratch);
  key_out[base + i] = k;
  sh.src[i] = src;  // published by the first batch's barrier
  const int nb = (C + kBatch - 1) / kBatch;
  for (int b = 0; b < nb; ++b) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
    __syncthreads();  // every thread's copies of batch b have landed
    const int c0 = b * kBatch;
    const int nc = C - c0 < kBatch ? C - c0 : kBatch;
    const int* buf = &sh.stage[b % kRing][0][0];
    for (int q = i; q < nc * kQuads; q += kTile) {
      const int c = q / kQuads, l = (q % kQuads) * 4;
      const int* row = buf + c * kTile;
      const int4 s = *reinterpret_cast<const int4*>(&sh.src[l]);
      *reinterpret_cast<int4*>(payload_out + (static_cast<size_t>(c0 + c) * T + tile) * kTile + l) =
          make_int4(row[s.x], row[s.y], row[s.z], row[s.w]);
    }
    __syncthreads();  // every thread has read the buffer: batch b + kRing may fill it
    issue(sh, payload, T, C, tile, b + kRing);
  }
}

}  // namespace

// key (T, 1024) int32, payload (C, T, 1024) int32 (16-byte aligned) ->
// key_out, payload_out (16-byte aligned)
extern "C" int sort_tiles(const int* key, const int* payload, int T, int C,
                          int* key_out, int* payload_out, void* stream) {
  if (T <= 0) return static_cast<int>(cudaSuccess);
  constexpr int smem = static_cast<int>(sizeof(Shared));
  const cudaError_t rc =
      cudaFuncSetAttribute(sort_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  sort_tiles_kernel<<<T, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      key, payload, T, C, key_out, payload_out);
  return static_cast<int>(cudaGetLastError());
}

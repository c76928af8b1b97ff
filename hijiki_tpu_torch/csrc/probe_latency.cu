// Latency micro-probes for Hopper (sm_90a): K11a latency_chain and
// staged_chase. Timing probes: the slope of their time over two trip counts
// (hijiki_tpu_torch/probes/timing.py) gives the cost of one link of a
// dependent chain, at one warp per SM (the exposed latency) and at full
// occupancy (the throughput).
//
// latency_chain, one kernel templated on the mode; each thread carries its
// own chain (the vote and chain modes: a group of kG threads, one warp at
// kG = 32, carries one). Replaces, in tools/chain_latency_probe.py:
//   alu    make_alu (:116, pallas_call :129): k dependent a*c + f ops a step,
//          f = i * 1e-12 (rounded twice: --fmad=false);
//   vote   make_vote (:153, :169): the bcast -> mul -> cmp -> any recurrence,
//          any = __any_sync over the warp at kG = 32, the thread alone at 1;
//   fetch  make_fetch (:193, :233): a row load from a (rows, ncols) f32 table
//          in global memory (a 4096 x 128 table is 2 MB: L2, not one SM's
//          L1), `indep` (cursor + 131, wrapped: the load's latency overlaps
//          the next step) or `chase` (next cursor = column 10 of the loaded
//          row: the latency lands on the chain), at heights 1 and 2. Thread
//          (b, j, c) of the (blocks, 8, ncols) output adds column c of row
//          min(cur, rows - h) + j % h of cursor 8b + j / h (the tool's
//          concatenation of 8 cursors' h-row slices, read as its first 8
//          rows); chase needs h = 1, the height the tool runs it at;
//   chain  make_chain (:260, :313): load -> slab min/max -> vote -> select,
//          the walker's recurrence without the prim test;
// and, in tools/gather_probe.py, _kernel / build (:42, :85):
//   gather the per-lane index chain idx -> table value -> idx over a
//          (K, 8, 128) f32 table staged in shared memory: `const` (no load),
//          `gather1` (entry idx & 1023 of tile 0), `gatherK` (entry idx & 1023
//          of tile (idx >> 10) & (K - 1)). The kernel gathers entry e, one
//          dependent shared-memory load a step, which is what the probe means
//          to measure; the TPU kernel's two take_along_axis calls read
//          tbl[r[i, l[i, j]], l[i, j]] instead (a lane order the plain
//          version keeps as order="tpu", held to JAX by the tests).
//
// staged_chase replaces make_dma (:430, pallas_call :508) and make_dma_multi
// (:330, :415): the GPU's counterpart of a DMA from HBM into VMEM. A warp
// carries the tool's 8 cursors: each step its 32 threads copy the 8 cursors'
// rows (128 f32 each, `height` rows a cursor) from global to shared memory
// with cp.async (16 bytes a thread a row), wait, and read column 0 (summed)
// and column 10 (the next cursor, `chase`) of the first 8 rows. Modes:
//   indep / chase        a commit group and a wait per cursor (the tool's 8
//                        semaphores), indices clamped to rows - height;
//   sharedsem            one commit group and one wait for the 8 copies;
//   sharedsem_noclamp    the same, indices unclamped;
//   dedup                cursor 0's rows only, read by all 8;
//   multi                nchains (1, 2, 4) chains of 8 equal cursors
//                        interleaved, each waited while the others' copies
//                        fly (cp.async.wait_group nchains - 1); `spec`
//                        starts both candidates (the row's column 10 and
//                        that + 1) and selects by the row's parity.
// The output is written a float4 a lane (a row a warp store). Hopper's
// bulk copy (cp.async.bulk, the TMA unit, issued by one lane and completing
// on mbarriers: the literal counterpart of make_async_copy and its
// semaphores) read 2.5x slower on the chase of 32,768 warps, a 512-byte row
// a copy (PERF.md section 6), so the per-lane copy stays.
// Its values are the fetch chain's arithmetic; the memory path changes the
// time, not the values. The table is the tool's (65536, 128) f32 (32 MB:
// resident in the 50 MB L2) or any `rows` (a larger one measures HBM).
//
// What bounds them: the latency of the chain's link, by design. The plain
// PyTorch twins are hijiki_tpu_torch/probes/chain_latency_probe.py and
// gather_probe.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe.cuh"

namespace {

constexpr int kSub = 8;      // cursors a set (the TPU's sublanes)
constexpr int kRowF = 128;   // floats a staged row

enum Mode { kAlu = 0, kVote = 1, kFetchIndep = 2, kFetchChase = 3, kChain = 4,
            kGatherConst = 5, kGather1 = 6, kGatherK = 7 };
enum StageMode { kIndep = 0, kChase = 1, kSharedSem = 2, kSharedSemNoClamp = 3,
                 kDedup = 4, kMulti = 5 };

constexpr float kAluC = 0x1.00001p+0f;   // f32(1.000001)
constexpr float kE12 = 0x1.197998p-40f;  // f32(1e-12)
constexpr float kE9 = 0x1.12e0bep-30f;   // f32(1e-9)

__device__ __forceinline__ int wrap_add(int cur, int step, int rows) {
  return cur + step < rows ? cur + step : cur - (rows - step);
}

// p0: fetch height / gather K; kG: the vote group; kK: alu ops a step
template <int kMode, int kG, int kK>
__global__ void latency_chain_kernel(const float* __restrict__ tbl, int rows,
                                     int ncols, const float* __restrict__ x,
                                     const int* __restrict__ idx0, int n, int iters,
                                     int p0, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (kMode >= kGatherConst) {
    // stage the (K, 8, 128) table in shared memory (every thread of the
    // block takes part before any returns)
    extern __shared__ float smem[];
    const int K = p0;
    for (int k = threadIdx.x; k < K * 1024; k += blockDim.x) smem[k] = tbl[k];
    __syncthreads();
    if (e >= n) return;
    const int mask = K * 1024 - 1;
    int id = idx0[e];
    const float t0 = smem[0];
    float acc = 0.0f;
    for (int i = 0; i < iters; ++i) {
      float v;
      if constexpr (kMode == kGatherConst) v = t0 + static_cast<float>(id);
      else if constexpr (kMode == kGather1) v = smem[id & 1023];
      else v = smem[id & mask];
      id = (id + static_cast<int>(v) + i) & mask;
      acc = acc + v;
    }
    out[e] = acc;
    out[n + e] = static_cast<float>(id);
    return;
  } else {
    if (e >= n) return;  // vote, chain: n % kG == 0
    if constexpr (kMode == kAlu) {
      float a = x[e];
      for (int i = 0; i < iters; ++i) {
        const float f = static_cast<float>(i) * kE12;
#pragma unroll
        for (int j = 0; j < kK / 2; ++j) a = a * kAluC + f;
      }
      out[e] = a;
    } else if constexpr (kMode == kVote) {
      const float xe = x[e];
      float v = 0.0f;
      for (int i = 0; i < iters; ++i) {
        const float f = static_cast<float>(i) * kE9;
        const float y = xe * (v + 1.0f) + f;
        v = group_any<kG>(y > 0.5f) ? v * 0.5f : v + 0.25f;
      }
      out[e] = v + xe;
    } else if constexpr (kMode == kFetchIndep || kMode == kFetchChase) {
      const int h = p0;
      const int s = e / ncols, c = e % ncols;
      const int b = s / kSub, j = s % kSub;
      int cur = ((kSub * b + j / h) * 7) % rows;  // the cursor this row reads
      int own = ((kSub * b + j) * 7) % rows;      // the cursor added at the end
      float acc = 0.0f;
      for (int i = 0; i < iters; ++i) {
        const float* r = tbl + static_cast<size_t>(min(cur, rows - h) + j % h) * ncols;
        acc = acc + r[c];
        if constexpr (kMode == kFetchChase) {
          cur = static_cast<int>(r[10]);
        } else {
          cur = wrap_add(cur, 131, rows);
          own = wrap_add(own, 131, rows);
        }
      }
      if constexpr (kMode == kFetchChase) own = cur;
      out[e] = acc + static_cast<float>(own);
    } else {  // kChain
      const float xe = x[e];
      int cur = ((e / kG) * 5) % rows;
      float desc = 0.0f, acc = 0.0f;
      const float* r = tbl + static_cast<size_t>(min(cur, rows - 1)) * ncols;
      int nexit = static_cast<int>(r[10]);
      for (int i = 0; i < iters; ++i) {
        int nxt = desc < 0.5f ? nexit : cur + 1;
        cur = nxt < rows ? nxt : nxt - rows;
        r = tbl + static_cast<size_t>(min(cur, rows - 1)) * ncols;
        nexit = static_cast<int>(r[10]);
        float ax = r[0] * xe, bx = r[3] * xe;
        float ay = r[1] * xe, by = r[4] * xe;
        float az = r[2] * xe, bz = r[5] * xe;
        float t0 = jmax(jmax(jmin(ax, bx), jmin(ay, by)), jmin(az, bz));
        float t1 = jmin(jmin(jmax(ax, bx), jmax(ay, by)), jmax(az, bz));
        desc = group_any<kG>(t0 < t1) ? 1.0f : 0.0f;
        acc = acc + group_first<kG>(t0);
      }
      out[e] = xe + acc + static_cast<float>(cur);
    }
  }
}

// --------------------------------------------------------- staged_chase --

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// lane `lane`'s 16 bytes of `h` rows from row `src` into `dst` (h rows)
__device__ __forceinline__ void copy_rows(float* dst, const float* tbl, int src,
                                          int h, int lane) {
  for (int q = 0; q < h; ++q)
    cp_async16(dst + q * kRowF + 4 * lane,
               tbl + static_cast<size_t>(src + q) * kRowF + 4 * lane);
}

// the row's 128 floats written as one float4 a lane (a row a warp store)
__device__ __forceinline__ void store_row(float* out, int b, int k, int lane, float val) {
  reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * kSub + k) * kRowF)[lane] =
      make_float4(val, val, val, val);
}

// per-cursor waits: wait_group 7, 6, ..., 0 after 8 committed groups
template <int N>
__device__ __forceinline__ void wait_each() {
  cp_wait<N>();
  if constexpr (N > 0) wait_each<N - 1>();
}

// make_dma: the 8 cursors of warp b; out (nblk, 8, 128)
template <int kMode>
__global__ void staged_chase_kernel(const float* __restrict__ tbl, int rows,
                                    int nblk, int iters, int h,
                                    float* __restrict__ out) {
  extern __shared__ __align__(16) float stage[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= nblk) return;  // whole warps
  float* scratch = stage + warp * kSub * h * kRowF;
  constexpr bool clamp = kMode != kSharedSemNoClamp && kMode != kDedup;
  int cur[kSub];
  float acc[kSub];
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    cur[k] = ((kSub * b + k) * 97) % rows;
    acc[k] = 0.0f;
  }
  auto start = [&]() {
    if constexpr (kMode == kDedup) {
      copy_rows(scratch, tbl, cur[0], h, lane);
      cp_commit();
      return;
    }
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      copy_rows(scratch + k * h * kRowF, tbl, clamp ? min(cur[k], rows - h) : cur[k],
                h, lane);
      if constexpr (kMode == kIndep || kMode == kChase) cp_commit();
    }
    if constexpr (kMode == kSharedSem || kMode == kSharedSemNoClamp) cp_commit();
  };
  auto wait = [&]() {
    if constexpr (kMode == kIndep || kMode == kChase) wait_each<kSub - 1>();
    else cp_wait<0>();
    __syncwarp();
  };
  start();
  for (int i = 0; i < iters; ++i) {
    wait();
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      const float* r = scratch + (kMode == kDedup ? 0 : k * kRowF);
      acc[k] = acc[k] + r[0];
      if constexpr (kMode == kChase) cur[k] = static_cast<int>(r[10]);
    }
    if constexpr (kMode != kChase) {
#pragma unroll
      for (int k = 0; k < kSub; ++k) cur[k] = cur[k] + 997 < rows ? cur[k] + 997
                                                                 : cur[k] - (rows - 997);
    }
    __syncwarp();  // every lane has read the rows before they are overwritten
    start();
  }
  wait();
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    const float val = acc[k] + static_cast<float>(cur[k]);
    store_row(out, b, k, lane, val);
  }
}

// make_dma_multi: kG interleaved chains of 8 equal cursors, kSpec both
// candidates; out (nblk, 8, 128)
template <int kG, bool kSpec>
__global__ void staged_multi_kernel(const float* __restrict__ tbl, int rows,
                                    int nblk, int iters, float* __restrict__ out) {
  constexpr int kSlots = kSpec ? 2 : 1;
  extern __shared__ __align__(16) float stage[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= nblk) return;
  float* scratch = stage + warp * kG * kSlots * kSub * kRowF;
  auto slot = [&](int g, int s) { return scratch + (g * kSlots + s) * kSub * kRowF; };
  int cur[kG][kSub];
  float acc[kG][kSub];
  // one copy set: the 8 cursors' rows, clamped to rows - 1
  auto start = [&](int g, int s, const int* c) {
#pragma unroll
    for (int k = 0; k < kSub; ++k)
      copy_rows(slot(g, s) + k * kRowF, tbl, min(c[k], rows - 1), 1, lane);
  };
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      cur[g][k] = (97 * (g + 1) + kSub * 97 * b) % rows;
      acc[g][k] = 0.0f;
    }
    start(g, 0, cur[g]);
    if (kSpec) start(g, 1, cur[g]);
    cp_commit();
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      cp_wait<kG - 1>();  // chain g's set is the oldest in flight
      __syncwarp();
      int nxt[kSub], nxt1[kSub];
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        const float* r = slot(g, 0) + k * kRowF;
        if (kSpec && (static_cast<int>(r[0]) & 1) > 0) r = slot(g, 1) + k * kRowF;
        acc[g][k] = acc[g][k] + r[0];
        nxt[k] = static_cast<int>(r[10]);
        nxt1[k] = nxt[k] + 1 < rows ? nxt[k] + 1 : 0;
      }
      __syncwarp();
      start(g, 0, nxt);
      if (kSpec) start(g, 1, nxt1);
      cp_commit();
#pragma unroll
      for (int k = 0; k < kSub; ++k) cur[g][k] = nxt[k];
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    float tot = acc[0][k];
#pragma unroll
    for (int g = 1; g < kG; ++g) tot = tot + acc[g][k];
    const float val = tot + static_cast<float>(cur[0][k]);
    store_row(out, b, k, lane, val);
  }
}

template <int kMode, int kG, int kK>
int chain_launch(const float* tbl, int rows, int ncols, const float* x,
                 const int* idx, int n, int iters, int p0, int block, float* out,
                 int* occ, void* stream) {
  const size_t smem = kMode >= kGatherConst ? static_cast<size_t>(p0) * 1024 * 4 : 0;
  return launch(latency_chain_kernel<kMode, kG, kK>, n, block, smem, occ, stream, tbl,
                rows, ncols, x, idx, n, iters, p0, out);
}

}  // namespace

// K11a latency_chain. mode: Mode above; p0: alu ops a step (8, 16, 32),
// fetch height, gather K; group 1 or 32 (vote, chain). out: (n,) f32, gather (2, n).
extern "C" int latency_chain(int mode, int group, const float* tbl, int rows,
                             int ncols, const float* x, const int* idx, int n,
                             int iters, int p0, int block, float* out, int* occ,
                             void* stream) {
#define CHAIN(m, g, k)                                                          \
  return chain_launch<m, g, k>(tbl, rows, ncols, x, idx, n, iters, p0, block, out, \
                               occ, stream)
  switch (mode) {
    case kAlu:
      if (p0 == 8) CHAIN(kAlu, 1, 8);
      if (p0 == 16) CHAIN(kAlu, 1, 16);
      if (p0 == 32) CHAIN(kAlu, 1, 32);
      break;
    case kVote:
      if (group == 32) CHAIN(kVote, 32, 0);
      CHAIN(kVote, 1, 0);
    case kFetchIndep: CHAIN(kFetchIndep, 1, 0);
    case kFetchChase: CHAIN(kFetchChase, 1, 0);
    case kChain:
      if (group == 32) CHAIN(kChain, 32, 0);
      CHAIN(kChain, 1, 0);
    case kGatherConst: CHAIN(kGatherConst, 1, 0);
    case kGather1: CHAIN(kGather1, 1, 0);
    case kGatherK: CHAIN(kGatherK, 1, 0);
  }
#undef CHAIN
  return static_cast<int>(cudaErrorInvalidValue);
}

// K11a staged_chase. mode: StageMode above; nblk warps of 8 cursors; height
// (not multi) 1, 2 or 4; nchains (multi) 1, 2 or 4; spec (multi) 0 or 1;
// block: threads a block, a multiple of 32. out: (nblk, 8, 128) f32.
extern "C" int staged_chase(int mode, const float* tbl, int rows, int nblk, int iters,
                            int height, int nchains, int spec, int block, float* out,
                            int* occ, void* stream) {
  const int threads = nblk * 32, warps = block / 32;
  const size_t per_warp = static_cast<size_t>(kSub) * kRowF * 4;
  const size_t smem_h = warps * per_warp * height;
  switch (mode) {
    case kIndep:
      return launch(staged_chase_kernel<kIndep>, threads, block, smem_h, occ, stream,
                    tbl, rows, nblk, iters, height, out);
    case kChase:
      return launch(staged_chase_kernel<kChase>, threads, block, smem_h, occ, stream,
                    tbl, rows, nblk, iters, height, out);
    case kSharedSem:
      return launch(staged_chase_kernel<kSharedSem>, threads, block, smem_h, occ,
                    stream, tbl, rows, nblk, iters, height, out);
    case kSharedSemNoClamp:
      return launch(staged_chase_kernel<kSharedSemNoClamp>, threads, block, smem_h,
                    occ, stream, tbl, rows, nblk, iters, height, out);
    case kDedup:
      return launch(staged_chase_kernel<kDedup>, threads, block, smem_h, occ, stream,
                    tbl, rows, nblk, iters, height, out);
    case kMulti: {
      const size_t smem = warps * per_warp * nchains * (spec ? 2 : 1);
#define MULTI(g, s)                                                              \
  return launch(staged_multi_kernel<g, s>, threads, block, smem, occ, stream, tbl, \
                rows, nblk, iters, out)
      if (nchains == 1) { if (spec) MULTI(1, true); MULTI(1, false); }
      if (nchains == 2) { if (spec) MULTI(2, true); MULTI(2, false); }
      if (nchains == 4) { if (spec) MULTI(4, true); MULTI(4, false); }
#undef MULTI
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

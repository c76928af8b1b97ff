// K9: the pre-hoisting R = 2 bilateral reconstruction stencil for Hopper
// (sm_90a), the A side of tools/ab_reconstruct.py's A/B against K3.
//
// Replaces _old_kernel (tools/ab_reconstruct.py:37-116, pallas_call :135),
// which reconstruct_old launches. The plain PyTorch version of every line
// below is hijiki_tpu_torch/probes/ab_reconstruct.py::reconstruct_old_plain.
//
// Input: the tool's (7, Hp, W) f32 planes (r, g, b, the weight 1, nx, ny,
// nz), Hp = H rounded up to 8-row strips (the pad rows are zero and never
// read: in_img masks every tap at qy >= H), the sample offset and the f32
// constants gauss_fac and curve_offset (math.exp(gauss_fac R^2) in double,
// rounded to f32 on the host, as the tool's f32(curve_offset)). Output:
// (H, W, 4) f32, written as one float4 a pixel.
//
// For each pixel and each of the 25 taps, dy outer and dx inner, it
// recomputes what K3 hoists: the spatial weight
//   w_sp = expf(gauss_fac * (offx^2 + offy^2)) - curve_offset,
//   offx = (f32(dx) + so_x) - 0.5 (this association, for the bits),
// and the block-splat masks in_img, in_splat and center_valid from the
// block origins floor(qx / B) B and floor(qy / B) B; it weights the normal
// term by expf(-2 |n(q) - n_center|^2), with the center normal zero on
// spill pixels, and drops a tap whose products are NaN or whose spatial
// weight is negative. That per-tap work is what the A/B against K3 prices,
// so the tap loops stay rolled (a tap an iteration, as the first version
// compiled). The TPU kernel read its column neighbours by a wrapping lane
// roll that in_img then masked; here the tap is read from the staged tile
// only where in_img holds.
//
// What the TPU kernel had and the first version of this one did not, so
// that the A/B differs from K3 only in the hoisting:
// * B was static there (cfg["block"]), so qx // B divided by a constant.
//   Here the host computes a multiplier m and shift s for B once per call
//   (ab_reconstruct.divisor_constants), as a compiler does for a constant
//   divisor: n / B = umulhi(2n, m) >> s for every n < 2^31, and a q in
//   [-2, 0) takes -((B - 1 - q) / B). No run-time integer division is left
//   (the first version's two a tap: 2 MUFU.RCP in a 203-instruction tap).
// * It staged a window of rows in VMEM; here each 32 x 8 block stages its
//   pixels with a 2-pixel halo in shared memory, K3's tile
//   (reconstruct.cu): (r, g, b, w) and (nx, ny, nz, 0) as float4s, so each
//   plane value is read from device memory about once and a tap reads two
//   128-bit shared words (the first version read 7 planes a tap).
//
// What bounds it: at 1024^2 the bytes are 44 a pixel (7 planes in, 4
// channels out), 46.1 MB, 0.0138 ms at 3.35 TB/s. The f32 operations are
// 35 a tap (K3's 25 and the spatial weight's 10, an expf counted as one),
// 875 a pixel, 0.92e9 at 1024^2: 0.0137 ms at 67 TFLOP/s (0.0274 at the
// 33.5 T ops/s of --fmad=false). So issue bounds it: the 25 expf a pixel
// that K3 does not have and the per-tap mask arithmetic are the A/B's
// difference.
//
// Numerics: built with --fmad=false, so every a*b+c rounds twice as the
// plain version's separate torch ops do; expf differs from torch.exp by an
// ULP or two, so kernel and plain version agree to K3's bound, not bit for
// bit. The division by multiplier is exact, so the output is the first
// version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 2;
constexpr int kTx = 32;
constexpr int kTy = 8;
constexpr int kSw = kTx + 2 * kR;
constexpr int kSh = kTy + 2 * kR;

// floor(q / B) for q >= -2 by the host's multiplier and shift for B
__device__ __forceinline__ int floordiv(int q, int B, unsigned m, int s) {
  const unsigned n = q >= 0 ? static_cast<unsigned>(q) : static_cast<unsigned>(B - 1 - q);
  const int d = static_cast<int>(__umulhi(2u * n, m) >> s);
  return q >= 0 ? d : -d;
}

__global__ void __launch_bounds__(kTx * kTy)
    reconstruct_old_kernel(const float* __restrict__ planes, int Hp, int H, int W, int B,
                           unsigned div_mul, int div_shift, float so_x, float so_y,
                           float gauss_fac, float curve_offset, float* __restrict__ out) {
  __shared__ float4 cw[kSh][kSw];   // r, g, b, the weight
  __shared__ float4 nrm[kSh][kSw];  // nx, ny, nz, 0
  const size_t plane = static_cast<size_t>(Hp) * W;
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  for (int idx = threadIdx.y * kTx + threadIdx.x; idx < kSh * kSw; idx += kTx * kTy) {
    const int ty = idx / kSw, tx = idx % kSw;
    const int gy = y0 + ty - kR, gx = x0 + tx - kR;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f), n = c;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float* q = planes + static_cast<size_t>(gy) * W + gx;
      c = make_float4(q[0], q[plane], q[2 * plane], q[3 * plane]);
      n = make_float4(q[4 * plane], q[5 * plane], q[6 * plane], 0.0f);
    }
    cw[ty][tx] = c;
    nrm[ty][tx] = n;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const float4 nc = nrm[threadIdx.y + kR][threadIdx.x + kR];
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 1
  for (int dy = -kR; dy <= kR; ++dy) {
#pragma unroll 1
    for (int dx = -kR; dx <= kR; ++dx) {
      const float offx = (static_cast<float>(dx) + so_x) - 0.5f;
      const float offy = (static_cast<float>(dy) + so_y) - 0.5f;
      const float w_sp = expf(gauss_fac * (offx * offx + offy * offy)) - curve_offset;
      const int qx = x + dx, qy = y + dy;
      const bool in_img = qx >= 0 && qx < W && qy >= 0 && qy < H;
      const int ox = floordiv(qx, B, div_mul, div_shift) * B;
      const int oy = floordiv(qy, B, div_mul, div_shift) * B;
      const int dw = min(B, W - ox), dh = min(B, H - oy);
      const int lx = x - ox, ly = y - oy;
      const bool in_splat = lx >= 0 && ly >= 0 && lx < dw + kR && ly < dh + kR;
      const bool center_valid = lx < dw && ly < dh;
      if (!in_img) continue;  // the roll's wrapped read, masked
      const float4 n = nrm[threadIdx.y + kR + dy][threadIdx.x + kR + dx];
      const float4 c = cw[threadIdx.y + kR + dy][threadIdx.x + kR + dx];
      const float dnx = n.x - (center_valid ? nc.x : 0.0f);
      const float dny = n.y - (center_valid ? nc.y : 0.0f);
      const float dnz = n.z - (center_valid ? nc.z : 0.0f);
      const float w = w_sp * expf(-2.0f * (dnx * dnx + dny * dny + dnz * dnz));
      const float c0 = w * c.x, c1 = w * c.y, c2 = w * c.z, c3 = w * c.w;
      const bool nan = isnan(c0) || isnan(c1) || isnan(c2) || isnan(c3);
      if (!(w_sp >= 0.0f) || !in_splat || nan) continue;
      a0 = a0 + c0;
      a1 = a1 + c1;
      a2 = a2 + c2;
      a3 = a3 + c3;
    }
  }
  reinterpret_cast<float4*>(out)[static_cast<size_t>(y) * W + x] = make_float4(a0, a1, a2, a3);
}

}  // namespace

// planes: (7, Hp, W) f32 device; B >= 1 and its divisor constants div_mul,
// div_shift (ab_reconstruct.divisor_constants); so_x, so_y: the sample
// offset; gauss_fac, curve_offset: f32 constants; out: (H, W, 4) f32 device.
// With `occ` non-null, launch nothing and write the blocks one SM holds at
// once.
extern "C" int reconstruct_old(const float* planes, int Hp, int H, int W, int B,
                               unsigned div_mul, int div_shift, float so_x, float so_y,
                               float gauss_fac, float curve_offset, float* out, int* occ,
                               void* stream) {
  if (occ != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, reconstruct_old_kernel, kTx * kTy, 0));
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(kTx, kTy);
  dim3 grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy);
  reconstruct_old_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      planes, Hp, H, W, B, div_mul, div_shift, so_x, so_y, gauss_fac, curve_offset, out);
  return static_cast<int>(cudaGetLastError());
}

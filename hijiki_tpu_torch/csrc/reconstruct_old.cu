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
// and the block-splat masks in_img, in_splat and center_valid from the block
// size; it weights the normal term by expf(-2 |n(q) - n_center|^2), with the
// center normal zero on spill pixels, and drops a tap whose products are NaN
// or whose spatial weight is negative. The TPU kernel read its column
// neighbours by a wrapping lane roll that in_img then masked; here a thread
// reads the neighbour directly and only when in_img holds.
//
// Design: one thread per output pixel in blocks of 32 x 8, reading the
// planar layout directly (neighbouring threads take neighbouring columns of
// one plane, so the reads coalesce; the 25 taps of a warp overlap in L1).
// The per-tap recomputation is kept on purpose: it is the un-hoisted variant
// K3 is compared against.
//
// What bounds it: at 1024^2 the bytes are 44 a pixel (7 planes in, 4
// channels out), 46.1 MB, 0.0138 ms at 3.35 TB/s. The f32 operations are
// 35 a tap (K3's 25 and the spatial weight's 10, an expf counted as one),
// 875 a pixel, 0.92e9 at 1024^2: 0.0137 ms at 67 TFLOP/s. So the two bounds
// are close; the 25 expf a pixel that K3 does not have, and the block-size
// divisions of its masks (integer, not counted), are the difference to look
// for in the A/B.
//
// Numerics: built with --fmad=false, so every a*b+c rounds twice as the
// plain version's separate torch ops do; expf differs from torch.exp by an
// ULP or two, so kernel and plain version agree to K3's bound, not bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 2;
constexpr int kTx = 32;
constexpr int kTy = 8;

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__global__ void __launch_bounds__(kTx * kTy)
    reconstruct_old_kernel(const float* __restrict__ planes, int Hp, int H, int W,
                           int B, float so_x, float so_y, float gauss_fac,
                           float curve_offset, float* __restrict__ out) {
  const int x = blockIdx.x * kTx + threadIdx.x;
  const int y = blockIdx.y * kTy + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t plane = static_cast<size_t>(Hp) * W;
  const float* cr = planes;
  const float* cg = planes + plane;
  const float* cb = planes + 2 * plane;
  const float* cw = planes + 3 * plane;
  const float* nx = planes + 4 * plane;
  const float* ny = planes + 5 * plane;
  const float* nz = planes + 6 * plane;
  const size_t p = static_cast<size_t>(y) * W + x;
  const float ncx = nx[p], ncy = ny[p], ncz = nz[p];
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int dy = -kR; dy <= kR; ++dy) {
    for (int dx = -kR; dx <= kR; ++dx) {
      const float offx = (static_cast<float>(dx) + so_x) - 0.5f;
      const float offy = (static_cast<float>(dy) + so_y) - 0.5f;
      const float w_sp = expf(gauss_fac * (offx * offx + offy * offy)) - curve_offset;
      const int qx = x + dx, qy = y + dy;
      const bool in_img = qx >= 0 && qx < W && qy >= 0 && qy < H;
      const int ox = floordiv(qx, B) * B, oy = floordiv(qy, B) * B;
      const int dw = min(B, W - ox), dh = min(B, H - oy);
      const int lx = x - ox, ly = y - oy;
      const bool in_splat = lx >= 0 && ly >= 0 && lx < dw + kR && ly < dh + kR;
      const bool center_valid = lx < dw && ly < dh;
      if (!in_img) continue;  // the roll's wrapped read, masked
      const size_t q = static_cast<size_t>(qy) * W + qx;
      const float dnx = nx[q] - (center_valid ? ncx : 0.0f);
      const float dny = ny[q] - (center_valid ? ncy : 0.0f);
      const float dnz = nz[q] - (center_valid ? ncz : 0.0f);
      const float w = w_sp * expf(-2.0f * (dnx * dnx + dny * dny + dnz * dnz));
      const float c0 = w * cr[q], c1 = w * cg[q], c2 = w * cb[q], c3 = w * cw[q];
      const bool nan = isnan(c0) || isnan(c1) || isnan(c2) || isnan(c3);
      if (!(w_sp >= 0.0f) || !in_splat || nan) continue;
      a0 = a0 + c0;
      a1 = a1 + c1;
      a2 = a2 + c2;
      a3 = a3 + c3;
    }
  }
  reinterpret_cast<float4*>(out)[p] = make_float4(a0, a1, a2, a3);
}

}  // namespace

// planes: (7, Hp, W) f32 device; so_x, so_y: the sample offset;
// gauss_fac, curve_offset: f32 constants; out: (H, W, 4) f32 device. With
// `occ` non-null, launch nothing and write the blocks one SM holds at once.
extern "C" int reconstruct_old(const float* planes, int Hp, int H, int W, int B,
                               float so_x, float so_y, float gauss_fac,
                               float curve_offset, float* out, int* occ,
                               void* stream) {
  if (occ != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, reconstruct_old_kernel, kTx * kTy, 0));
  dim3 block(kTx, kTy);
  dim3 grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy);
  reconstruct_old_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      planes, Hp, H, W, B, so_x, so_y, gauss_fac, curve_offset, out);
  return static_cast<int>(cudaGetLastError());
}

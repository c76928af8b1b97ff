// Bilateral reconstruction stencil (R = 2) for Hopper (sm_90a).
//
// Replaces hijiki_tpu/render/pallas_reconstruct.py::_reconstruct_kernel.
// The plain twin is hijiki_tpu_torch/render/reconstruct.py::reconstruct_sweep
// (zero albedo), and this kernel computes what it computes: for each output
// pixel p and tap q = p + delta, |delta| <= 2,
//   w = wsp[delta] * exp(-2 |n(q) - n_center|^2)
// where wsp = [exp(gaussFac |delta + so - 0.5|^2) - curveOffset] is computed
// once per block with the twin's f32 operations (spatial_weights), with the
// reference's block-splat masks (no left/top spill; zero center normal on
// spill pixels), out-of-image taps masked (the Pallas roll wraps; its mask
// hides the wrap) and NaN contributions rejected. The sample weight is 1, so
// the fourth output channel accumulates w itself. Taps accumulate in the
// Pallas kernel's order: dy outer, dx inner.
//
// Design: one thread per output pixel, 32 x 8 pixels per block; the block
// stages the (H, W, 3) radiance and normal buffers with a 2-pixel halo in
// shared memory, so each input value is read from device memory about once.
// What bounds it: memory — 24 bytes in and 16 bytes out per pixel, a few
// hundred flops; the film delta is written straight in (H, W, 4) layout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 2;
constexpr int kTaps = (2 * kR + 1) * (2 * kR + 1);
constexpr int kTx = 32;
constexpr int kTy = 8;
constexpr int kSw = kTx + 2 * kR;
constexpr int kSh = kTy + 2 * kR;

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__global__ void __launch_bounds__(kTx * kTy)
    reconstruct_kernel(const float* __restrict__ color,
                       const float* __restrict__ normal, float so_x, float so_y,
                       float gauss_fac, int H, int W, int B,
                       float* __restrict__ out) {
  __shared__ float tile[6][kSh][kSw];  // r, g, b, nx, ny, nz
  __shared__ float taps[kTaps];
  const int tid = threadIdx.y * kTx + threadIdx.x;
  if (tid < kTaps) {
    // the twin's spatial_weights, operation for operation in f32
    const float ox = static_cast<float>(tid % (2 * kR + 1) - kR) + (so_x - 0.5f);
    const float oy = static_cast<float>(tid / (2 * kR + 1) - kR) + (so_y - 0.5f);
    const float curve = expf(gauss_fac * static_cast<float>(kR * kR));
    taps[tid] = expf(gauss_fac * (ox * ox + oy * oy)) - curve;
  }
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  for (int idx = tid; idx < kSh * kSw; idx += kTx * kTy) {
    int ty = idx / kSw, tx = idx % kSw;
    int gy = y0 + ty - kR, gx = x0 + tx - kR;
    bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    size_t off = (static_cast<size_t>(gy) * W + gx) * 3;
    for (int c = 0; c < 3; ++c) {
      tile[c][ty][tx] = in ? color[off + c] : 0.0f;
      tile[3 + c][ty][tx] = in ? normal[off + c] : 0.0f;
    }
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int cx = threadIdx.x + kR, cy = threadIdx.y + kR;
  const float ncx = tile[3][cy][cx], ncy = tile[4][cy][cx], ncz = tile[5][cy][cx];
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int dy = -kR; dy <= kR; ++dy) {
    const int qy = y + dy;
    const int oy = floordiv(qy, B) * B;
    const int dh = min(B, H - oy);
    const int lyq = y - oy;
    const bool in_y = qy >= 0 && qy < H;
    const bool splat_y = lyq >= 0 && lyq < dh + kR;
    const bool center_y = lyq < dh;
    for (int dx = -kR; dx <= kR; ++dx) {
      const float wsp = taps[(dy + kR) * (2 * kR + 1) + (dx + kR)];
      const int qx = x + dx;
      const int ox = floordiv(qx, B) * B;
      const int dw = min(B, W - ox);
      const int lxq = x - ox;
      const bool in_x = qx >= 0 && qx < W;
      const bool splat_x = lxq >= 0 && lxq < dw + kR;
      const bool center = center_y && lxq < dw;
      if (!(wsp >= 0.0f) || !(in_x && in_y) || !(splat_x && splat_y)) continue;
      const int sy = cy + dy, sx = cx + dx;
      float dnx = tile[3][sy][sx] - (center ? ncx : 0.0f);
      float dny = tile[4][sy][sx] - (center ? ncy : 0.0f);
      float dnz = tile[5][sy][sx] - (center ? ncz : 0.0f);
      float s = dnx * dnx + dny * dny + dnz * dnz;
      float w = wsp * expf(-(s * 2.0f));
      float c0 = w * tile[0][sy][sx], c1 = w * tile[1][sy][sx];
      float c2 = w * tile[2][sy][sx];
      if (isnan(c0) || isnan(c1) || isnan(c2) || isnan(w)) continue;
      a0 = a0 + c0;
      a1 = a1 + c1;
      a2 = a2 + c2;
      a3 = a3 + w;
    }
  }
  reinterpret_cast<float4*>(out)[static_cast<size_t>(y) * W + x] =
      make_float4(a0, a1, a2, a3);
}

}  // namespace

// color, normal: (H, W, 3) f32 device; so_x, so_y: this sweep's sample
// offset; gauss_fac: -1 / (2 stddev^2) as f32; out: (H, W, 4) f32 device.
extern "C" int reconstruct(const float* color, const float* normal, float so_x,
                           float so_y, float gauss_fac, int H, int W, int B,
                           float* out, void* stream) {
  dim3 block(kTx, kTy);
  dim3 grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy);
  reconstruct_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      color, normal, so_x, so_y, gauss_fac, H, W, B, out);
  return static_cast<int>(cudaGetLastError());
}

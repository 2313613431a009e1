// B2: bit-exact interleaved conv2d (NHWC, VALID, stride 1).
//
// Replaces the Pallas kernel src/repro/kernels/approx_conv.py
// (am_conv2d_bitexact_kernel -> _make_kernel), the paper CNN's compute.
// Each (filter, ky, kx) tap carries its own multiplier variant, shared over
// the input channels.
//
// One thread per output (b, oy, ox, f). For each tap, in (ky, kx) order, the
// Cin products are summed one after another from c = 0 into a tap sum that
// starts at 0.0f, and the tap sum is then added to the output accumulator,
// which also starts at 0.0f. kernels/ref.py::am_conv2d_bitexact_ref pins the
// same order, so the two agree bitwise. Adds are __fadd_rn, never contracted.
//
// Bound: integer operations, about 4x10^2 per emulated multiply (am_fp32.cuh)
// and no tensor-core use; the bytes moved are a few per multiply, all cached.
// The design spends nothing on data movement: a thread reads its 3x3xCin
// window and the tap weights straight through the L1 cache, and the variant's
// 15 column masks once per tap.
#include <cuda_runtime.h>

#include "am_fp32.cuh"

namespace {

__global__ void __launch_bounds__(256)
am_conv2d_bitexact_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const int* __restrict__ slot,
                          const unsigned long long* __restrict__ masks,
                          float* __restrict__ out, int B, int H, int W, int C,
                          int F, int KH, int KW) {
  const int HO = H - KH + 1, WO = W - KW + 1;
  const long long total = (long long)B * HO * WO * F;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int f = (int)(idx % F);
  long long r = idx / F;
  const int ox = (int)(r % WO);
  r /= WO;
  const int oy = (int)(r % HO);
  const int b = (int)(r / HO);

  float acc = 0.0f;
  for (int ky = 0; ky < KH; ++ky) {
    for (int kx = 0; kx < KW; ++kx) {
      const int tap = (f * KH + ky) * KW + kx;
      uint64_t m[am::MASKS_PER_VARIANT];
      const unsigned long long* mv = masks + (long long)slot[tap] * am::MASKS_PER_VARIANT;
      AM_UNROLL
      for (int j = 0; j < am::MASKS_PER_VARIANT; ++j) m[j] = mv[j];
      const float* xp = x + (((long long)b * H + oy + ky) * W + ox + kx) * C;
      const float* wp = w + (long long)tap * C;
      float tap_sum = 0.0f;
      for (int c = 0; c < C; ++c) tap_sum = __fadd_rn(tap_sum, am::mul(xp[c], wp[c], m));
      acc = __fadd_rn(acc, tap_sum);
    }
  }
  out[idx] = acc;
}

}  // namespace

// x (B,H,W,C) f32, w (F,KH,KW,C) f32, slot (F,KH,KW) i32 variant ids,
// masks (V,3,5) u64, out (B,H-KH+1,W-KW+1,F) f32; all contiguous on the
// device. Returns cudaGetLastError() after the launch.
extern "C" int am_conv2d_bitexact_launch(const void* x, const void* w, const void* slot,
                                         const void* masks, void* out, int B, int H,
                                         int W, int C, int F, int KH, int KW,
                                         void* stream) {
  const long long total = (long long)B * (H - KH + 1) * (W - KW + 1) * F;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    am_conv2d_bitexact_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (const int*)slot,
        (const unsigned long long*)masks, (float*)out, B, H, W, C, F, KH, KW);
  }
  return (int)cudaGetLastError();
}

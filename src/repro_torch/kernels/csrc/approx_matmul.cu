// B3: bit-exact approximate-multiplier matmul, x (M,K) @ w (K,N).
//
// Replaces the Pallas kernel src/repro/kernels/approx_matmul.py
// (am_matmul_bitexact_kernel -> _kernel). Each scalar product x[m,k]*w[k,n]
// goes through the emulated multiplier of the (k, n) slot's variant.
//
// One thread per output (m, n), neighbouring threads on neighbouring n, so
// the loads of w and of the variant ids coalesce and x[m, k] is a broadcast.
// The Pallas grid summed each k block of its tile and added the blocks in
// order; here the k loop runs in blocks of chunk_k: each block's products are
// summed one after another from k0 into a block sum that starts at 0.0f, and
// the block sum is added to the accumulator (which starts at 0.0f).
// kernels/ref.py::am_matmul_bitexact_ref(chunk_k=...) pins the same order.
//
// Bound: integer operations, about 4x10^2 per emulated multiply (am_fp32.cuh)
// and no tensor-core use.
#include <cuda_runtime.h>

#include "am_fp32.cuh"

namespace {

__global__ void __launch_bounds__(256)
am_matmul_bitexact_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const int* __restrict__ vids,
                          const unsigned long long* __restrict__ masks,
                          float* __restrict__ out, int M, int K, int N, int chunk_k) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * N) return;
  const int n = (int)(idx % N);
  const int m = (int)(idx / N);
  const float* xr = x + (long long)m * K;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += chunk_k) {
    const int k1 = min(k0 + chunk_k, K);
    float blk = 0.0f;
    for (int k = k0; k < k1; ++k) {
      const long long kn = (long long)k * N + n;
      const unsigned long long* mv = masks + (long long)vids[kn] * am::MASKS_PER_VARIANT;
      uint64_t mk[am::MASKS_PER_VARIANT];
      AM_UNROLL
      for (int j = 0; j < am::MASKS_PER_VARIANT; ++j) mk[j] = mv[j];
      blk = __fadd_rn(blk, am::mul(xr[k], w[kn], mk));
    }
    acc = __fadd_rn(acc, blk);
  }
  out[idx] = acc;
}

}  // namespace

// x (M,K) f32, w (K,N) f32, vids (K,N) i32, masks (V,3,5) u64, out (M,N) f32;
// all contiguous on the device. Returns cudaGetLastError() after the launch.
extern "C" int am_matmul_bitexact_launch(const void* x, const void* w, const void* vids,
                                         const void* masks, void* out, int M, int K,
                                         int N, int chunk_k, void* stream) {
  const long long total = (long long)M * N;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    am_matmul_bitexact_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (const int*)vids,
        (const unsigned long long*)masks, (float*)out, M, K, N, chunk_k);
  }
  return (int)cudaGetLastError();
}

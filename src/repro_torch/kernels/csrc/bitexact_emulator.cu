// B4: (V, n) emulated products of one operand stream under V scheme maps.
//
// Replaces the Pallas kernel src/repro/kernels/bitexact_emulator.py
// (fp32_multiply_stacked_kernel -> _kernel). The Booth rows are the half of
// the emulation that no map reads, so each thread decodes its operand pair
// and builds, once, the 10 row words, the first stage's mask-free terms and
// the pair's sign, exponent and operand rules; then, for each of the V maps,
// it runs only the code selection, the later stages and the normalisation. The Pallas version padded n to
// its chunk and V to its variant block; here one thread per operand needs
// no padding, and neighbouring threads write neighbouring outputs of a row.
//
// Bound: integer operations (the Booth rows once, then about 2x10^2 per map
// and operand; chip_smoke.py counts both parts in the SASS of probes), and
// no tensor-core use.
#include <cuda_runtime.h>

#include "am_fp32.cuh"

namespace {

__global__ void __launch_bounds__(256)
fp32_multiply_stacked_kernel(const float* __restrict__ a, const float* __restrict__ b,
                             const unsigned long long* __restrict__ masks,
                             float* __restrict__ out, int V, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const am::Operand oa = am::decode(a[i]), ob = am::decode(b[i]);
  const am::Pair pr = am::pair(oa, ob);
  uint64_t rows[10];
  am::booth_rows(oa.man24, ob.man24, rows);
  const am::TreeHead head = am::tree_head(rows);
  for (int v = 0; v < V; ++v) {
    uint64_t m[am::MASKS_PER_VARIANT];
    AM_UNROLL
    for (int j = 0; j < am::MASKS_PER_VARIANT; ++j)
      m[j] = masks[(long long)v * am::MASKS_PER_VARIANT + j];
    out[(long long)v * n + i] = am::finish(am::tree_tail(head, m), pr);
  }
}

}  // namespace

// a, b (n,) f32, masks (V,3,5) u64 (one entry per map), out (V,n) f32; all
// contiguous on the device. Returns cudaGetLastError() after the launch.
extern "C" int fp32_multiply_stacked_launch(const void* a, const void* b,
                                            const void* masks, void* out, int V,
                                            long long n, void* stream) {
  if (n > 0 && V > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    fp32_multiply_stacked_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const unsigned long long*)masks,
        (float*)out, V, n);
  }
  return (int)cudaGetLastError();
}

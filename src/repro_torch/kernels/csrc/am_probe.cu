// Probes for counting the integer operations of the B1 multiply.
//
// Not a kernel of the main path: chip_smoke.py reads their SASS
// (cuobjdump -sass) and counts the arithmetic instructions of one emulated
// multiply, which sets the operations bound of B2, B3 and B4. The body of
// am_fp32.cuh has no data-dependent branch, so each probe's static
// instruction count is the count every thread executes.
//   am_probe_full: decode, Booth rows, tree, finish (B2 and B3 per product);
//   am_probe_head: decode, Booth rows, the tree's mask-free first-stage
//                  terms and the pair's operand rules (B4, once per pair);
//   am_probe_tail: code selection, later stages and finish (B4, per map).
#include <cuda_runtime.h>

#include "am_fp32.cuh"

extern "C" __global__ void am_probe_full(const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         const unsigned long long* __restrict__ masks,
                                         float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint64_t m[am::MASKS_PER_VARIANT];
  AM_UNROLL
  for (int j = 0; j < am::MASKS_PER_VARIANT; ++j) m[j] = masks[j];
  out[i] = am::mul(a[i], b[i], m);
}

extern "C" __global__ void am_probe_head(const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         am::TreeHead* __restrict__ head_out,
                                         am::Pair* __restrict__ pair_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const am::Operand oa = am::decode(a[i]), ob = am::decode(b[i]);
  uint64_t rows[10];
  am::booth_rows(oa.man24, ob.man24, rows);
  head_out[i] = am::tree_head(rows);
  pair_out[i] = am::pair(oa, ob);
}

extern "C" __global__ void am_probe_tail(const am::TreeHead* __restrict__ heads,
                                         const am::Pair* __restrict__ pairs,
                                         const unsigned long long* __restrict__ masks,
                                         float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint64_t m[am::MASKS_PER_VARIANT];
  AM_UNROLL
  for (int j = 0; j < am::MASKS_PER_VARIANT; ++j) m[j] = masks[j];
  out[i] = am::finish(am::tree_tail(heads[i], m), pairs[i]);
}

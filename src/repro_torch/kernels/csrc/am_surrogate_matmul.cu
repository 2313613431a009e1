// B5, B6, B7: the fused surrogate approximate-multiplier matmuls.
//
// Replace the Pallas kernels of src/repro/kernels/am_surrogate_matmul.py:
//   B5 am_surrogate_matmul_epilogue_kernel (_epilogue_kernel, _epilogue_kernel_pop):
//        out = x @ wm + z * sqrt(max((x*x) @ wv, 0)), with an optional population
//        axis P on the weights and optionally on x; z (M, N) is shared across P;
//   B6 am_surrogate_matmul_folded_kernel (_folded_kernel): (mean, var) from the
//        folded weights wm, wv;
//   B7 am_surrogate_matmul_kernel (_kernel): (mean, var) from the unfolded w, mu,
//        sg; wm = w*(1+mu) and wv = (w*w)*(sg*sg) are formed as the tile is loaded.
// One template covers the three: {folded | unfolded} x {epilogue | moments}. The
// population axes are the grid's z dimension, with per-genome strides that are
// 0 where an operand is shared.
//
// Layout: a block of 256 threads computes a 64 x 64 output tile, 4 x 4 outputs
// per thread at rows ty + 16 i and columns tx + 16 j, so that neighbouring
// threads read neighbouring words of shared memory and store neighbouring
// outputs. The k loop walks tiles of 16 through shared memory (x as a
// transposed 16 x 64 tile, wm and wv as 16 x 64 tiles). Two accumulators per
// output; the epilogue runs after the last k tile, while the sums are still in
// registers. Ragged edges are masked in the kernel, nothing is padded.
//
// Order (pinned; kernels/ref.py::am_surrogate_moments_ref repeats it): for each
// output, an accumulator starts at 0.0f; k runs in blocks of 16
// (ops.MATMUL_CHUNK_K, B3's order); a block sum starts at 0.0f and adds its
// products x*wm (and (x*x)*wv) one after another in k order; then the block sum
// is added to the accumulator. Every product and sum is written with the
// round-to-nearest intrinsics, so nvcc cannot contract a*b+c into an FMA: the
// kernel equals its plain version bit for bit.
//
// Bound: operations. Two GEMMs of 2*M*K*N flops each; with a separate mul and
// add per multiply-accumulate the FP32 pipe does at most half the FMA peak, so
// this kernel cannot pass 50% of the FMA-peak bound. No tensor cores, TF32 or
// wgmma: the pinned order needs one rounding per product and per add.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int TROWS = BM / TM, TCOLS = BN / TN;  // 16 x 16 threads

struct Tile {
  float xs[BK][BM + 1];  // x^T; the pad keeps the transposed stores off one bank
  float ms[BK][BN];
  float vs[BK][BN];
};

// One k step of a tile: a product into each block sum of the thread's outputs.
__device__ __forceinline__ void mac(const Tile& t, int kk, int ty, int tx,
                                    float (&bm)[TM][TN], float (&bv)[TM][TN]) {
  float xr[TM], xq[TM], wm[TN], wv[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    xr[i] = t.xs[kk][ty + TROWS * i];
    xq[i] = __fmul_rn(xr[i], xr[i]);
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    wm[j] = t.ms[kk][tx + TCOLS * j];
    wv[j] = t.vs[kk][tx + TCOLS * j];
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      bm[i][j] = __fadd_rn(bm[i][j], __fmul_rn(xr[i], wm[j]));
      bv[i][j] = __fadd_rn(bv[i][j], __fmul_rn(xq[i], wv[j]));
    }
  }
}

// UNFOLDED: wa, wb, wc are w, mu, sg (else wa, wb are wm, wv). EPILOGUE: out0 is
// the noisy output and z is read (else out0, out1 are mean and var).
template <bool UNFOLDED, bool EPILOGUE>
__global__ void __launch_bounds__(THREADS)
surrogate_matmul_kernel(const float* __restrict__ x, const float* __restrict__ wa,
                        const float* __restrict__ wb, const float* __restrict__ wc,
                        const float* __restrict__ z, float* __restrict__ out0,
                        float* __restrict__ out1, int M, int K, int N,
                        long long x_pop_stride, long long w_pop_stride) {
  __shared__ Tile t;
  const int tid = threadIdx.x;
  const int tx = tid % TCOLS, ty = tid / TCOLS;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long p = blockIdx.z;
  x += p * x_pop_stride;
  wa += p * w_pop_stride;
  wb += p * w_pop_stride;
  if (UNFOLDED) wc += p * w_pop_stride;
  const long long out_off = p * (long long)M * N;

  float am[TM][TN], av[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) am[i][j] = av[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kn = min(BK, K - k0);
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int m = m0 + r;
      t.xs[c][r] = (m < M && c < kn) ? x[(long long)m * K + k0 + c] : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int n = n0 + c;
      float vm = 0.0f, vv = 0.0f;
      if (r < kn && n < N) {
        const long long i = (long long)(k0 + r) * N + n;
        if (UNFOLDED) {
          const float w = wa[i], mu = wb[i], sg = wc[i];
          vm = __fmul_rn(w, __fadd_rn(1.0f, mu));
          vv = __fmul_rn(__fmul_rn(w, w), __fmul_rn(sg, sg));
        } else {
          vm = wa[i];
          vv = wb[i];
        }
      }
      t.ms[r][c] = vm;
      t.vs[r][c] = vv;
    }
    __syncthreads();

    float bm[TM][TN], bv[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) bm[i][j] = bv[i][j] = 0.0f;
    if (kn == BK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) mac(t, kk, ty, tx, bm, bv);
    } else {  // the ragged last block adds only its kn products
      for (int kk = 0; kk < kn; ++kk) mac(t, kk, ty, tx, bm, bv);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        am[i][j] = __fadd_rn(am[i][j], bm[i][j]);
        av[i][j] = __fadd_rn(av[i][j], bv[i][j]);
      }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + TROWS * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + TCOLS * j;
      if (n >= N) continue;
      const long long o = (long long)m * N + n;
      if (EPILOGUE) {
        // max(var, 0) that keeps a NaN, as the plain version's clamp and the
        // reference's jnp.maximum do (fmaxf would drop it).
        const float v = av[i][j] < 0.0f ? 0.0f : av[i][j];
        out0[out_off + o] = __fadd_rn(am[i][j], __fmul_rn(z[o], __fsqrt_rn(v)));
      } else {
        out0[out_off + o] = am[i][j];
        out1[out_off + o] = av[i][j];
      }
    }
  }
}

template <bool UNFOLDED, bool EPILOGUE>
int launch(const void* x, const void* wa, const void* wb, const void* wc, const void* z,
           void* out0, void* out1, int P, int M, int K, int N, long long x_pop_stride,
           long long w_pop_stride, void* stream) {
  if (P > 0 && M > 0 && N > 0) {
    const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
                    (unsigned)P);
    surrogate_matmul_kernel<UNFOLDED, EPILOGUE><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)wa, (const float*)wb, (const float*)wc,
        (const float*)z, (float*)out0, (float*)out1, M, K, N, x_pop_stride, w_pop_stride);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// All pointers are contiguous f32 on the device. Each entry point returns
// cudaGetLastError() after its launch.

// B5: x (M,K), or (P,M,K) with x_pop_stride = M*K (else 0); wm, wv (K,N), or
// (P,K,N) with w_pop_stride = K*N (else 0, P = 1); z (M,N); out (P,M,N).
extern "C" int am_surrogate_matmul_epilogue_launch(const void* x, const void* wm,
                                                   const void* wv, const void* z, void* out,
                                                   int P, int M, int K, int N,
                                                   long long x_pop_stride,
                                                   long long w_pop_stride, void* stream) {
  return launch<false, true>(x, wm, wv, nullptr, z, out, nullptr, P, M, K, N, x_pop_stride,
                             w_pop_stride, stream);
}

// B6: x (M,K), wm, wv (K,N) -> mean, var (M,N).
extern "C" int am_surrogate_matmul_folded_launch(const void* x, const void* wm,
                                                 const void* wv, void* mean, void* var,
                                                 int M, int K, int N, void* stream) {
  return launch<false, false>(x, wm, wv, nullptr, nullptr, mean, var, 1, M, K, N, 0, 0,
                              stream);
}

// B7: x (M,K), w, mu, sg (K,N) -> mean, var (M,N).
extern "C" int am_surrogate_matmul_launch(const void* x, const void* w, const void* mu,
                                          const void* sg, void* mean, void* var, int M,
                                          int K, int N, void* stream) {
  return launch<true, false>(x, w, mu, sg, nullptr, mean, var, 1, M, K, N, 0, 0, stream);
}

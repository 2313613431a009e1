// B1: the emulated approximate FP32 multiply, one element at a time.
//
// The shared body of the three bit-exact kernels (approx_conv.cu,
// approx_matmul.cu, bitexact_emulator.cu). It replaces what the JAX package
// traces inside each Pallas kernel: src/repro/core/fp32_mul.py::fp32_multiply
// (mantissa_multiply_bits and the Booth / compressor modules under it). That
// version holds a product as a (10, 48) int32 bit tensor; here each of the 10
// partial-product rows is one 48-bit word in a uint64, each stage's compressor
// codes are five 48-bit column masks (EXACT, PC1, PC2, NC1, NC2), and a 4:2
// stage over all 48 columns is a handful of word-wide logic operations.
//
// Bound: integer operations. A multiply is about 4x10^2 integer instructions
// (chip_smoke.py counts them in the SASS of a one-multiply probe) and uses
// no tensor core; the operands are 8 bytes. The design keeps everything in
// registers: 10 row words, no tables, no branches on data (selects only).
// B4 splits it where no scheme map is read yet (tree_head, pair) from the
// part each map repeats (tree_tail, finish).
//
// The functions are __host__ __device__ so that g++ can build the same
// arithmetic for a CPU check against the PyTorch version
// (src/repro_torch/core/fp32_mul.py), which follows it step for step.
#pragma once

#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define AM_HD __host__ __device__ __forceinline__
#define AM_UNROLL _Pragma("unroll")
#else
#define AM_HD static inline
#define AM_UNROLL
#endif

namespace am {

constexpr uint64_t MASK48 = (1ull << 48) - 1;
constexpr uint32_t MAN23 = (1u << 23) - 1;
constexpr uint32_t QNAN_BITS = 0x7FC00000u;
// uint64 masks per variant: [stage 0..2][code EXACT, PC1, PC2, NC1, NC2].
constexpr int MASKS_PER_VARIANT = 15;

AM_HD uint32_t float_bits(float x) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(x);
#else
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
#endif
}

AM_HD float bits_float(uint32_t u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float x;
  memcpy(&x, &u, 4);
  return x;
#endif
}

AM_HD int clz64(uint64_t v) {
#if defined(__CUDA_ARCH__)
  return __clzll((long long)v);
#else
  return __builtin_clzll(v);
#endif
}

// One float32 operand, unpacked as the reference does.
struct Operand {
  uint32_t sign, exp, man;  // raw fields
  uint32_t man24;           // with the implicit bit (0 for subnormals)
  int eff;                  // unbiased exponent of the 1.M / 0.M fixed point
};

AM_HD Operand decode(float x) {
  const uint32_t u = float_bits(x);
  Operand o;
  o.sign = u >> 31;
  o.exp = (u >> 23) & 0xFF;
  o.man = u & MAN23;
  o.man24 = o.exp ? (o.man | (1u << 23)) : o.man;
  o.eff = o.exp ? (int)o.exp - 127 : -126;
  return o;
}

// The 10 radix-8 Booth rows of a24 * b24: rows 0..8 are |d_i| * a24 << 3i,
// one's-complemented over 48 bits for a negative digit; row 9 counts the
// negative digits (their +1 corrections).
AM_HD void booth_rows(uint32_t a24, uint32_t b24, uint64_t rows[10]) {
  const uint64_t bb = (uint64_t)b24 << 1;  // bit 0 is b[-1] = 0
  uint64_t neg_count = 0;
  AM_UNROLL
  for (int i = 0; i < 9; ++i) {
    const uint32_t g = (uint32_t)(bb >> (3 * i)) & 0xF;
    const int d = (int)(g & 1) + (int)((g >> 1) & 1) + 2 * (int)((g >> 2) & 1) -
                  4 * (int)((g >> 3) & 1);
    const uint64_t neg = d < 0 ? MASK48 : 0;
    const uint64_t mag = (uint64_t)(d < 0 ? -d : d) * a24;
    rows[i] = ((mag << (3 * i)) & MASK48) ^ neg;
    neg_count += d < 0;
  }
  rows[9] = neg_count;
}

// The mask-free terms of one 4:2 stage over all 48 columns: the sum and
// the carry that each compressor code would give.
struct StageTerms {
  uint64_t sum_exact, sum_pc1, sum_nc;  // PC2 keeps the exact sum, NC1/NC2 drop cin
  uint64_t carry_exact, carry_pc2, carry_nc1, carry_nc2;  // PC1 keeps the exact carry
};

AM_HD StageTerms stage_terms(uint64_t x1, uint64_t x2, uint64_t x3, uint64_t x4) {
  const uint64_t cin = (((x1 & x2) | ((x1 ^ x2) & x3)) << 1) & MASK48;
  const uint64_t t = x1 ^ x2 ^ x3;
  const uint64_t sx = t ^ x4;
  const uint64_t t4 = t & x4;
  StageTerms o;
  o.sum_exact = sx ^ cin;
  o.sum_pc1 = o.sum_exact | (x1 & x2) | (x3 & x4);
  o.sum_nc = sx;
  o.carry_exact = (sx & cin) | t4;
  o.carry_pc2 = o.carry_exact | ((x1 ^ x2) & x3 & x4);
  o.carry_nc1 = t4;
  o.carry_nc2 = t4 & ~(x1 & x2 & x3 & x4);
  return o;
}

// Pick each column's sum and carry by its code; m: the stage's five column
// masks (EXACT, PC1, PC2, NC1, NC2). The carry moves up one column.
AM_HD void stage_select(const StageTerms& o, const uint64_t* m, uint64_t& s, uint64_t& c) {
  s = (o.sum_exact & (m[0] | m[2])) | (o.sum_pc1 & m[1]) | (o.sum_nc & (m[3] | m[4]));
  c = (o.carry_exact & (m[0] | m[1])) | (o.carry_pc2 & m[2]) | (o.carry_nc1 & m[3]) |
      (o.carry_nc2 & m[4]);
  c = (c << 1) & MASK48;
}

// The part of the tree that no map reads: the first stage's terms of rows
// 0-3 and 4-7, and the rows 8 and 9 that join in the last stage.
struct TreeHead {
  StageTerms a, b;
  uint64_t r8, r9;
};

AM_HD TreeHead tree_head(const uint64_t r[10]) {
  TreeHead h;
  h.a = stage_terms(r[0], r[1], r[2], r[3]);
  h.b = stage_terms(r[4], r[5], r[6], r[7]);
  h.r8 = r[8];
  h.r9 = r[9];
  return h;
}

// The rest of the 3-stage tree and the exact final add (mod 2^48);
// m: the map's 15 masks.
AM_HD uint64_t tree_tail(const TreeHead& h, const uint64_t* m) {
  uint64_t sa, ca, sb, cb, s1, k1, s2, k2;
  stage_select(h.a, m, sa, ca);
  stage_select(h.b, m, sb, cb);
  stage_select(stage_terms(sa, ca, sb, cb), m + 5, s1, k1);
  stage_select(stage_terms(s1, k1, h.r8, h.r9), m + 10, s2, k2);
  return (s2 + k2) & MASK48;
}

// What the finish needs from an operand pair, computed once per pair: B4
// reuses it for every map. The operand rules (NaN, Inf and zero operands)
// exclude each other, so one precomputed result covers them all.
struct Pair {
  uint32_t sign;     // the product's sign, in bit 31
  int exp_base;      // biased exponent of the result when the leading one is at 0
  bool special;      // an operand rule decides the result
  uint32_t special_bits;
};

AM_HD Pair pair(const Operand& a, const Operand& b) {
  Pair p;
  p.sign = (a.sign ^ b.sign) << 31;
  p.exp_base = a.eff + b.eff - 46 + 127;
  const bool a_nan = a.exp == 255 && a.man != 0, b_nan = b.exp == 255 && b.man != 0;
  const bool a_inf = a.exp == 255 && a.man == 0, b_inf = b.exp == 255 && b.man == 0;
  const bool a_zero = a.exp == 0 && a.man == 0, b_zero = b.exp == 0 && b.man == 0;
  const bool nan_out = a_nan || b_nan || (a_inf && b_zero) || (b_inf && a_zero);
  const bool zero_out = a_zero || b_zero, inf_out = a_inf || b_inf;
  p.special = nan_out || zero_out || inf_out;
  p.special_bits = nan_out ? QNAN_BITS : (zero_out ? p.sign : (p.sign | 0x7F800000u));
  return p;
}

// Normalise and truncate the 48-bit product; FTZ and overflow; then the
// operand rules.
AM_HD float finish(uint64_t prod, const Pair& p) {
  const int msb = prod ? 63 - clz64(prod) : 47;
  const uint32_t man23 =
      (uint32_t)(msb >= 23 ? prod >> (msb - 23) : prod << (23 - msb)) & MAN23;
  const int e = p.exp_base + msb;
  const uint32_t ec = (uint32_t)(e < 1 ? 1 : (e > 254 ? 254 : e));
  uint32_t bits = p.sign | (ec << 23) | man23;
  bits = (e <= 0 || prod == 0) ? p.sign : bits;
  bits = e >= 255 ? (p.sign | 0x7F800000u) : bits;
  bits = p.special ? p.special_bits : bits;
  return bits_float(bits);
}

// The whole multiply under one variant's 15 column masks.
AM_HD float mul(float x, float y, const uint64_t* masks) {
  const Operand a = decode(x), b = decode(y);
  uint64_t rows[10];
  booth_rows(a.man24, b.man24, rows);
  return finish(tree_tail(tree_head(rows), masks), pair(a, b));
}

}  // namespace am

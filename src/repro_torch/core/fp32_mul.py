"""Bit-exact emulation of the paper's approximate FP32 multipliers (torch).

Pipeline: sign XOR | exponent add | 24x24 mantissa multiply through radix-8
Booth rows and a 3-stage 4:2-compressor tree, approximate in columns 0..23,
then normalisation and truncation. This is the plain PyTorch version of the
multiply that the CUDA header ``kernels/csrc/am_fp32.cuh`` computes per
element, in the same layout: each of the 10 partial-product rows is one
48-bit word in an int64, and each stage's codes are five 48-bit column masks.

Numerics contract (the JAX reference's):
  * the exact map reproduces the integer mantissa product; the packed result
    truncates (<= 1 ulp below IEEE round-to-nearest-even);
  * subnormal inputs are honoured (implicit bit 0, exponent -126), subnormal
    outputs flush to zero, overflow gives a signed Inf, NaN/Inf/zero follow
    IEEE; the NaN produced is 0x7FC00000;
  * the 48-bit datapath wraps mod 2^48.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import booth, compressors as C, schemes

MASK48 = booth.MASK48
MAN23 = (1 << 23) - 1
QNAN_BITS = 0x7FC00000


def unpack(x: torch.Tensor):
    """float32 -> (sign, biased_exp, man23, man24, eff_exp) int64 fields."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF
    s = bits >> 31
    e = (bits >> 23) & 0xFF
    m = bits & MAN23
    man24 = torch.where(e > 0, m | (1 << 23), m)
    eff = torch.where(e > 0, e - 127, torch.full_like(e, -126))
    return s, e, m, man24, eff


def from_bits(bits: torch.Tensor) -> torch.Tensor:
    """int64 tensor of 32-bit patterns -> float32 tensor with those bits."""
    signed = bits - ((bits >> 31) << 32)
    return signed.to(torch.int32).view(torch.float32)


def code_masks(scheme_codes) -> torch.Tensor:
    """(..., 3, 48) compressor codes -> (..., 3, 5) int64 column masks.

    Mask k of a stage has bit j set where column j of that stage uses code k.
    """
    if isinstance(scheme_codes, torch.Tensor):
        codes = scheme_codes.to(torch.int64)
    else:
        codes = torch.from_numpy(np.array(scheme_codes, np.int64))
    k = torch.arange(C.N_COMPRESSORS, dtype=torch.int64, device=codes.device)
    col = torch.arange(booth.N_COLS, dtype=torch.int64, device=codes.device)
    hit = (codes.unsqueeze(-2) == k[:, None]).to(torch.int64)  # (...,3,5,48)
    return (hit << col).sum(dim=-1)


def stack_masks(device) -> torch.Tensor:
    """(N_VARIANTS, 3, 5) int64 column masks of the seed alphabet."""
    return code_masks(schemes.scheme_stack()).to(device)


def _stage(r1, r2, r3, r4, m):
    """One 4:2 stage over all 48 columns; m: the stage's 5 masks."""
    cin = (C.cout42(r1, r2, r3) << 1) & MASK48
    s, c, _ = C.compress42(r1, r2, r3, r4, cin, m)
    return s, (c << 1) & MASK48


def compress_rows(rows: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Reduce (..., 10) Booth row words through the tree to the 48-bit product.

    masks: (..., 3, 5) column masks, broadcastable against the rows' batch
    shape (rows built once broadcast against many maps).
    """
    r = rows.unbind(-1)
    m0, m1, m2 = (masks[..., s, :].unbind(-1) for s in range(3))
    sa, ca = _stage(r[0], r[1], r[2], r[3], m0)
    sb, cb = _stage(r[4], r[5], r[6], r[7], m0)
    s1, k1 = _stage(sa, ca, sb, cb, m1)
    s2, k2 = _stage(s1, k1, r[8], r[9], m2)
    return (s2 + k2) & MASK48


def mantissa_multiply(a24, b24, masks) -> torch.Tensor:
    """48-bit product word of two 24-bit mantissas under column masks."""
    return compress_rows(booth.booth_rows(a24, b24), masks)


def _msb(p: torch.Tensor) -> torch.Tensor:
    """Index of the leading one of a 48-bit word; 47 for zero (the
    reference's argmax convention, which the overflow rule can observe)."""
    msb = torch.zeros_like(p)
    v = p
    for s in (32, 16, 8, 4, 2, 1):
        hi = (v >> s) != 0
        msb = msb + hi.to(torch.int64) * s
        v = torch.where(hi, v >> s, v)
    return torch.where(p == 0, torch.full_like(p, 47), msb)


def finish(prod, sa, ea, ma, eff_a, sb, eb, mb, eff_b) -> torch.Tensor:
    """Normalise, truncate and pack a 48-bit mantissa product, then apply the
    FTZ, overflow and IEEE special-operand rules."""
    sign = sa ^ sb
    msb = _msb(prod)
    man23 = torch.where(msb >= 23, prod >> (msb - 23).clamp(min=0),
                        prod << (23 - msb).clamp(min=0)) & MAN23
    e = eff_a + eff_b + (msb - 46) + 127
    bits = (sign << 31) | (e.clamp(1, 254) << 23) | man23
    zero = sign << 31
    inf = zero | (0xFF << 23)
    bits = torch.where((e <= 0) | (prod == 0), zero, bits)
    bits = torch.where(e >= 255, inf, bits)

    a_nan = (ea == 255) & (ma != 0)
    b_nan = (eb == 255) & (mb != 0)
    a_inf = (ea == 255) & (ma == 0)
    b_inf = (eb == 255) & (mb == 0)
    a_zero = (ea == 0) & (ma == 0)
    b_zero = (eb == 0) & (mb == 0)
    nan_out = a_nan | b_nan | (a_inf & b_zero) | (b_inf & a_zero)
    bits = torch.where((a_zero | b_zero) & ~nan_out, zero, bits)
    bits = torch.where((a_inf | b_inf) & ~nan_out, inf, bits)
    bits = torch.where(nan_out, torch.full_like(bits, QNAN_BITS), bits)
    return from_bits(bits)


def fp32_multiply_masks(a, b, masks) -> torch.Tensor:
    """Emulated a*b with per-element column masks (..., 3, 5).

    The Booth rows are built on the broadcast shape of ``a`` and ``b`` alone,
    so masks with extra leading dims (many maps against one operand stream)
    reuse them; only the compressor stages expand.
    """
    sa, ea, ma, man_a, eff_a = unpack(a)
    sb, eb, mb, man_b, eff_b = unpack(b)
    prod = mantissa_multiply(man_a, man_b, masks)
    return finish(prod, sa, ea, ma, eff_a, sb, eb, mb, eff_b)


def fp32_multiply(a, b, scheme_codes=None) -> torch.Tensor:
    """Emulated FP32 multiply a*b under a (..., 3, 48) code map (None: exact)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    if scheme_codes is None:
        scheme_codes = schemes.scheme_map("exact")
    return fp32_multiply_masks(a, b, code_masks(scheme_codes).to(a.device))


def fp32_multiply_interleaved(a, b, variant_ids, masks=None) -> torch.Tensor:
    """Multiply with a per-element variant id (broadcastable to a's shape).

    masks: optional (N_VARIANTS, 3, 5) mask stack (default: the seed
    alphabet's, built on a's device).
    """
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    if masks is None:
        masks = stack_masks(a.device)
    vids = torch.as_tensor(variant_ids, dtype=torch.int64, device=a.device)
    return fp32_multiply_masks(a, b, masks[vids])


def fp32_multiply_batch(a, b, variant, chunk: int = 1 << 16) -> np.ndarray:
    """Chunked host evaluation over large 1-D batches -> np.float32.

    ``variant`` is a variant name or an explicit (3, 48) scheme map.
    """
    a = torch.as_tensor(np.asarray(a, np.float32).ravel())
    b = torch.as_tensor(np.asarray(b, np.float32).ravel())
    codes = (schemes.scheme_map(variant) if isinstance(variant, str)
             else schemes.validate_scheme_map(variant))
    masks = code_masks(codes)
    outs = [fp32_multiply_masks(a[i:i + chunk], b[i:i + chunk], masks)
            for i in range(0, a.numel(), chunk)]
    return torch.cat(outs).numpy() if outs else np.zeros(0, np.float32)

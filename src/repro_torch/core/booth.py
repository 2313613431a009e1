"""Radix-8 modified-Booth partial products for a 24x24 mantissa multiply.

The 24-bit multiplier is recoded into 9 radix-8 digits d_i in [-4, 4]:

    d_i = -4*b[3i+2] + 2*b[3i+1] + b[3i] + b[3i-1],   b[-1] = b[>=24] = 0

so that B = sum_i d_i * 8^i for any unsigned 24-bit B. Partial product i is
``|d_i| * A`` shifted left by 3i; a negative digit contributes the 48-bit
one's complement of that row plus a +1, and the +1s of all negative digits
are gathered in a tenth correction row (their count, at most 9, in bits
0..3). So the 10 rows satisfy

    sum(rows) mod 2^48 == A * B.

Each row is one 48-bit word in an int64 (column j is bit j), the layout the
CUDA body in ``kernels/csrc/am_fp32.cuh`` uses too.
"""
from __future__ import annotations

import torch

N_COLS = 48
N_DIGITS = 9
MASK48 = (1 << N_COLS) - 1


def booth_digits(b24: torch.Tensor) -> torch.Tensor:
    """Recode unsigned 24-bit integers into (..., 9) radix-8 digits in [-4, 4]."""
    bb = b24.to(torch.int64) << 1  # bit 0 is b[-1] = 0
    digits = []
    for i in range(N_DIGITS):
        g = bb >> (3 * i)
        digits.append((g & 1) + ((g >> 1) & 1) + 2 * ((g >> 2) & 1)
                      - 4 * ((g >> 3) & 1))
    return torch.stack(digits, dim=-1)


def booth_rows(a24: torch.Tensor, b24: torch.Tensor) -> torch.Tensor:
    """(..., 10) int64 row words whose sum mod 2^48 is ``a24 * b24``, on the
    broadcast shape of the two."""
    a, b = torch.broadcast_tensors(a24.to(torch.int64), b24.to(torch.int64))
    d = booth_digits(b)
    neg = d < 0
    shifts = 3 * torch.arange(N_DIGITS, dtype=torch.int64, device=d.device)
    rows = ((d.abs() * a.unsqueeze(-1)) << shifts) & MASK48
    rows = torch.where(neg, ~rows & MASK48, rows)
    corr = neg.sum(dim=-1, dtype=torch.int64)
    return torch.cat([rows, corr.unsqueeze(-1)], dim=-1)

"""Exact and approximate 4:2 compressors as word-wide bit operations.

A 4:2 compressor takes four partial-product bits ``x1..x4`` of one column plus
a carry-in ``cin`` from the previous column and emits

    x1 + x2 + x3 + x4 + cin  =  sum + 2*(carry + cout)

``cout`` depends only on ``x1..x3``, so the column chain inside one stage is
not recursive. Here every argument is an int64 tensor whose low 48 bits are
the 48 columns of one partial-product row, so one bitwise operation handles
all columns at once. The compressor of each column is chosen by five column
masks, one per code (``EXACT, PC1, PC2, NC1, NC2``): bit j of mask k is set
when column j uses code k, and the five masks partition the 48 columns.

Per-code behaviour (see the JAX reference's truth-table summary):
  PC1: ``sum`` gains ``x1&x2 | x3&x4``           (error >= 0)
  PC2: ``carry`` gains ``(x1^x2)&x3&x4``         (error >= 0)
  NC1: ``cin`` is ignored                        (error <= 0)
  NC2: NC1, and ``carry`` is dropped on 1111     (error <= 0)
"""
from __future__ import annotations

import torch

EXACT = 0
PC1 = 1
PC2 = 2
NC1 = 3
NC2 = 4
N_COMPRESSORS = 5


def cout42(x1: torch.Tensor, x2: torch.Tensor, x3: torch.Tensor) -> torch.Tensor:
    """Exact cout (carry of the first embedded full adder), in every design."""
    return (x1 & x2) | ((x1 ^ x2) & x3)


def compress42(x1, x2, x3, x4, cin, masks):
    """Word-wide 4:2 compression with a per-column compressor choice.

    Args:
      x1..x4, cin: int64 tensors of column words (broadcastable).
      masks: sequence of the five int64 column masks (EXACT, PC1, PC2, NC1,
        NC2), each broadcastable against the words.
    Returns:
      (sum, carry, cout) column words, carry not yet shifted.
    """
    m_ex, m_pc1, m_pc2, m_nc1, m_nc2 = masks
    t = x1 ^ x2 ^ x3
    sx = t ^ x4
    cout = cout42(x1, x2, x3)
    sum_exact = sx ^ cin
    t4 = t & x4
    carry_exact = (sx & cin) | t4
    sum_pc1 = sum_exact | (x1 & x2) | (x3 & x4)
    carry_pc2 = carry_exact | ((x1 ^ x2) & x3 & x4)
    carry_nc2 = t4 & ~(x1 & x2 & x3 & x4)
    # PC2 keeps the exact sum, NC1 and NC2 share the cin-free sum sx, PC1
    # keeps the exact carry and NC1 the cin-free carry t&x4.
    s = (sum_exact & (m_ex | m_pc2)) | (sum_pc1 & m_pc1) | (sx & (m_nc1 | m_nc2))
    c = ((carry_exact & (m_ex | m_pc1)) | (carry_pc2 & m_pc2) | (t4 & m_nc1)
         | (carry_nc2 & m_nc2))
    return s, c, cout

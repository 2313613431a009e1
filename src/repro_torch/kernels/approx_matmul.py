"""B3: the bit-exact approximate-multiplier matmul kernel (CUDA).

Replaces the Pallas kernel ``src/repro/kernels/approx_matmul.py``
(``am_matmul_bitexact_kernel``): x (M,K) @ w (K,N) with one multiplier
variant per (k, n). The source, ``csrc/approx_matmul.cu``, says how the
kernel is laid out and what bounds it; its plain PyTorch version is
``ref.am_matmul_bitexact_ref(chunk_k=...)``, which pins the same order
(sequential within each k block, then the blocks in order).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_build import CudaKernel, require_cuda, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("approx_matmul.cu", "am_matmul_bitexact_launch",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P])


def am_matmul_bitexact_cuda(x: torch.Tensor, w: torch.Tensor, vids: torch.Tensor,
                            masks: torch.Tensor, chunk_k: int) -> torch.Tensor:
    """x (M,K) f32, w (K,N) f32, vids (K,N) int32 ids below masks.shape[0],
    masks (V,3,5) int64, all on one CUDA device -> (M, N) f32."""
    require_cuda("am_matmul_bitexact", x, w, vids, masks)
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("am_matmul_bitexact: x and w must be float32")
    if vids.dtype != torch.int32 or masks.dtype != torch.int64:
        raise ValueError("am_matmul_bitexact: vids int32, masks int64")
    m, k = x.shape
    k_w, n = w.shape
    if k_w != k or tuple(vids.shape) != (k, n) or chunk_k < 1:
        raise ValueError(f"am_matmul_bitexact: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, vids {tuple(vids.shape)}, "
                         f"chunk_k {chunk_k}")
    if masks.shape[1:] != (3, 5):
        raise ValueError(f"masks must be (V, 3, 5), got {tuple(masks.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    KERNEL.launch(x.data_ptr(), w.data_ptr(), vids.data_ptr(), masks.data_ptr(),
                  out.data_ptr(), m, k, n, chunk_k, stream_of(x))
    return out

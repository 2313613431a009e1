"""B4: the stacked bit-exact emulator kernel (CUDA).

Replaces the Pallas kernel ``src/repro/kernels/bitexact_emulator.py``
(``fp32_multiply_stacked_kernel``): the (V, n) products of one operand stream
under V scheme maps, the Booth rows built once per operand. The port's
surrogate calibration runs on it (``core/surrogate.py``). The source is
``csrc/bitexact_emulator.cu``; its plain PyTorch version is
``ref.fp32_multiply_stacked_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_build import CudaKernel, require_cuda, stream_of

_P = ctypes.c_void_p
KERNEL = CudaKernel("bitexact_emulator.cu", "fp32_multiply_stacked_launch",
                    [_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P])


def fp32_multiply_stacked_cuda(a: torch.Tensor, b: torch.Tensor,
                               masks: torch.Tensor) -> torch.Tensor:
    """a, b (n,) f32, masks (V,3,5) int64 (one entry per map), all on one
    CUDA device -> (V, n) f32."""
    require_cuda("fp32_multiply_stacked", a, b, masks)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("fp32_multiply_stacked: a and b must be float32")
    if a.dim() != 1 or a.shape != b.shape:
        raise ValueError(f"fp32_multiply_stacked: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if masks.dtype != torch.int64 or masks.dim() != 3 or masks.shape[1:] != (3, 5):
        raise ValueError(f"masks must be int64 (V, 3, 5), got {tuple(masks.shape)}")
    v, n = masks.shape[0], a.shape[0]
    out = torch.empty((v, n), dtype=torch.float32, device=a.device)
    KERNEL.launch(a.data_ptr(), b.data_ptr(), masks.data_ptr(), out.data_ptr(),
                  v, n, stream_of(a))
    return out

"""B2: the bit-exact interleaved conv2d kernel (CUDA), the paper CNN's compute.

Replaces the Pallas kernel ``src/repro/kernels/approx_conv.py``
(``am_conv2d_bitexact_kernel``). NHWC, VALID, stride 1; each (filter, ky, kx)
tap has its own multiplier variant, shared over the input channels. The
source, ``csrc/approx_conv.cu``, says how the kernel is laid out and what
bounds it; its plain PyTorch version is ``ref.am_conv2d_bitexact_ref``, which
pins the same summation order, so the two agree bitwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_build import CudaKernel, require_cuda, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("approx_conv.cu", "am_conv2d_bitexact_launch",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])


def am_conv2d_bitexact_cuda(x: torch.Tensor, w: torch.Tensor, slot_map: torch.Tensor,
                            masks: torch.Tensor) -> torch.Tensor:
    """x (B,H,W,Cin) f32, w (F,kh,kw,Cin) f32, slot_map (F,kh,kw) int32 ids
    below masks.shape[0], masks (V,3,5) int64 column masks, all on one CUDA
    device -> (B, H-kh+1, W-kw+1, F) f32."""
    require_cuda("am_conv2d_bitexact", x, w, slot_map, masks)
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("am_conv2d_bitexact: x and w must be float32")
    if slot_map.dtype != torch.int32 or masks.dtype != torch.int64:
        raise ValueError("am_conv2d_bitexact: slot_map int32, masks int64")
    b, h, wd, cin = x.shape
    f, kh, kw, cin_w = w.shape
    if cin_w != cin or tuple(slot_map.shape) != (f, kh, kw) or kh > h or kw > wd:
        raise ValueError(f"am_conv2d_bitexact: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, slot_map {tuple(slot_map.shape)}")
    if masks.shape[1:] != (3, 5):
        raise ValueError(f"masks must be (V, 3, 5), got {tuple(masks.shape)}")
    out = torch.empty((b, h - kh + 1, wd - kw + 1, f), dtype=torch.float32,
                      device=x.device)
    KERNEL.launch(x.data_ptr(), w.data_ptr(), slot_map.data_ptr(), masks.data_ptr(),
                  out.data_ptr(), b, h, wd, cin, f, kh, kw, stream_of(x))
    return out

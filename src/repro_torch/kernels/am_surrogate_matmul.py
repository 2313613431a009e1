"""B5, B6, B7: the fused surrogate AM matmul kernels (CUDA).

Replace the Pallas kernels of ``src/repro/kernels/am_surrogate_matmul.py``:

  B5 ``am_surrogate_matmul_epilogue_kernel``: out = x @ wm + z*sqrt(max(x^2 @ wv, 0)),
     one launch per call, with an optional population axis on the weights
     and on x (z shared across the population);
  B6 ``am_surrogate_matmul_folded_kernel``: (mean, var) from folded wm, wv;
  B7 ``am_surrogate_matmul_kernel``: (mean, var) from the unfolded w, mu, sg.

All three are entry points of one source, ``csrc/am_surrogate_matmul.cu``,
which says how the kernel is laid out and what bounds it. Their plain
PyTorch versions are ``ref.am_surrogate_moments_ref`` and
``ref.am_surrogate_epilogue_ref``, which pin the same summation order, so
kernel and plain version agree bitwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_build import CudaKernel, require_cuda, stream_of

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SOURCE = "am_surrogate_matmul.cu"
EPILOGUE = CudaKernel(SOURCE, "am_surrogate_matmul_epilogue_launch",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _P])
FOLDED = CudaKernel(SOURCE, "am_surrogate_matmul_folded_launch",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _P])
UNFOLDED = CudaKernel(SOURCE, "am_surrogate_matmul_launch",
                      [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P])

# The grid's y and z dimensions (64-row tiles, genomes) are at most 65535.
_MAX_GRID_YZ = 65535


def _check(name: str, x: torch.Tensor, ws: tuple[torch.Tensor, ...]):
    require_cuda(name, x, *ws)
    for t in (x, *ws):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 tensors, got {t.dtype}")
    m, k = x.shape[-2:]
    kw, n = ws[0].shape[-2:]
    if kw != k or any(w.shape != ws[0].shape for w in ws):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, "
                         f"w {[tuple(w.shape) for w in ws]}")
    if -(-m // 64) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: M = {m} rows exceed the grid")
    return m, k, n


def am_surrogate_matmul_epilogue_cuda(x: torch.Tensor, w_mean: torch.Tensor,
                                      w_var: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """B5. x (M,K) or (P,M,K), w_mean/w_var (K,N) or (P,K,N), z (M,N), all
    float32 and contiguous on one CUDA device -> (P?, M, N); the output has a
    population axis iff the weights have one, and x may have one only then."""
    name = "am_surrogate_matmul_epilogue"
    m, k, n = _check(name, x, (w_mean, w_var))
    require_cuda(name, x, z)
    pop, pop_x = w_mean.dim() == 3, x.dim() == 3
    p = w_mean.shape[0] if pop else 1
    if (pop_x and (not pop or x.shape[0] != p)) or x.dim() not in (2, 3) \
            or w_mean.dim() not in (2, 3) or tuple(z.shape) != (m, n) \
            or z.dtype != torch.float32 or p > _MAX_GRID_YZ:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w {tuple(w_mean.shape)}, "
                         f"z {tuple(z.shape)} {z.dtype}")
    out = torch.empty(((p,) if pop else ()) + (m, n), dtype=torch.float32,
                      device=x.device)
    EPILOGUE.launch(x.data_ptr(), w_mean.data_ptr(), w_var.data_ptr(), z.data_ptr(),
                    out.data_ptr(), p, m, k, n, m * k if pop_x else 0,
                    k * n if pop else 0, stream_of(x))
    return out


def _moments(kernel: CudaKernel, name: str, x: torch.Tensor, *ws: torch.Tensor):
    if x.dim() != 2 or ws[0].dim() != 2:
        raise ValueError(f"{name}: x (M,K) and weights (K,N), got {tuple(x.shape)}, "
                         f"{tuple(ws[0].shape)}")
    m, k, n = _check(name, x, ws)
    mean = torch.empty((m, n), dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    kernel.launch(x.data_ptr(), *(w.data_ptr() for w in ws), mean.data_ptr(),
                  var.data_ptr(), m, k, n, stream_of(x))
    return mean, var


def am_surrogate_moments_folded_cuda(x: torch.Tensor, w_mean: torch.Tensor,
                                     w_var: torch.Tensor):
    """B6. x (M,K), w_mean/w_var (K,N), float32 contiguous on one CUDA device
    -> (mean, var), both (M, N)."""
    return _moments(FOLDED, "am_surrogate_moments_folded", x, w_mean, w_var)


def am_surrogate_moments_cuda(x: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
                              sg: torch.Tensor):
    """B7. x (M,K), w/mu/sg (K,N), float32 contiguous on one CUDA device ->
    (mean, var), both (M, N); w(1+mu) and w^2 sg^2 are formed in the kernel."""
    return _moments(UNFOLDED, "am_surrogate_moments", x, w, mu, sg)

"""Kernel entry points: validation and dispatch by device.

A tensor on the CPU goes to the kernel's plain PyTorch version
(``kernels/ref.py``); a tensor on a CUDA device goes to the CUDA kernel,
which raises if it cannot build or launch. There is no other path.

The Pallas entry points padded shapes to block multiples and cropped the
result; the CUDA kernels mask the ragged ends themselves, so nothing is
padded here. The block chooser and its tuning cache (and so the reference's
``block=`` and ``impl=`` arguments) have no counterpart yet (ROADMAP A10).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import fp32_mul, schemes, surrogate
from repro_torch.kernels import ref

# The k block of the pinned summation order of the bit-exact matmul (the
# Pallas kernel's default bk) and of the surrogate matmuls. CPU and CUDA use
# the same order, so they agree bitwise.
MATMUL_CHUNK_K = 16


@functools.lru_cache(maxsize=None)
def _seed_masks(device: str) -> torch.Tensor:
    return fp32_mul.stack_masks(device)


def seed_masks(device) -> torch.Tensor:
    """(N_VARIANTS, 3, 5) column masks of the seed alphabet on a device."""
    return _seed_masks(str(torch.device(device)))


def _on(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no AM kernel for device {t.device}")


def _variant_ids(ids, shape, device) -> torch.Tensor:
    arr = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids)
    if arr.shape != tuple(shape):
        raise ValueError(f"variant ids shape {arr.shape} != {tuple(shape)}")
    if arr.size and (arr.min() < 0 or arr.max() >= schemes.N_VARIANTS):
        raise ValueError(f"variant ids must be in [0, {schemes.N_VARIANTS})")
    return torch.from_numpy(arr.astype(np.int32)).to(device)


def am_conv2d_bitexact(x: torch.Tensor, w: torch.Tensor, slot_map) -> torch.Tensor:
    """Bit-exact interleaved conv2d (NHWC, VALID, stride 1): B2 on the card."""
    slot = _variant_ids(slot_map, w.shape[:3], x.device)
    if _on(x) == "cpu":
        return ref.am_conv2d_bitexact_ref(x, w, slot, seed_masks(x.device))
    from repro_torch.kernels import approx_conv

    return approx_conv.am_conv2d_bitexact_cuda(
        x.float().contiguous(), w.float().contiguous(), slot, seed_masks(x.device))


def am_matmul_bitexact(x: torch.Tensor, w: torch.Tensor, variant_ids,
                       chunk_k: int = MATMUL_CHUNK_K) -> torch.Tensor:
    """Bit-exact AM matmul x (M,K) @ w (K,N): B3 on the card."""
    vids = _variant_ids(variant_ids, w.shape, x.device)
    if _on(x) == "cpu":
        return ref.am_matmul_bitexact_ref(x, w, vids, chunk_k=chunk_k,
                                          masks=seed_masks(x.device))
    from repro_torch.kernels import approx_matmul

    return approx_matmul.am_matmul_bitexact_cuda(
        x.float().contiguous(), w.float().contiguous(), vids, seed_masks(x.device),
        chunk_k)


def fp32_multiply_stacked(a: torch.Tensor, b: torch.Tensor, scheme_maps) -> torch.Tensor:
    """(V, n) emulated products of a, b (n,) f32 under V (3, 48) scheme maps:
    B4 on the card."""
    maps = np.asarray(scheme_maps)
    if maps.ndim != 3 or maps.shape[1:] != (3, 48):
        raise ValueError(f"scheme_maps must be (V, 3, 48), got {maps.shape}")
    masks = fp32_mul.code_masks(
        np.stack([schemes.validate_scheme_map(m) for m in maps])).to(a.device)
    a = a.float().reshape(-1).contiguous()
    b = b.float().reshape(-1).contiguous()
    if _on(a) == "cpu":
        return ref.fp32_multiply_stacked_ref(a, b, masks)
    from repro_torch.kernels import bitexact_emulator

    return bitexact_emulator.fp32_multiply_stacked_cuda(a, b, masks)


# ---------------------------------------------------------------------------
# Surrogate matmul: moments, folded moments, fused noise epilogue (B5-B7)
# ---------------------------------------------------------------------------


def _f32(*ts: torch.Tensor):
    return tuple(t.float().contiguous() for t in ts)


def am_surrogate_moments(x: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
                         sg: torch.Tensor):
    """(mean, var) of the surrogate AM matmul from the unfolded per-slot
    moments: x (M,K), w/mu/sg (K,N) -> two (M,N) float32. B7 on the card."""
    x, w, mu, sg = _f32(x, w, mu, sg)
    if _on(x) == "cpu":
        return ref.am_surrogate_unfolded_ref(x, w, mu, sg, MATMUL_CHUNK_K)
    from repro_torch.kernels import am_surrogate_matmul

    return am_surrogate_matmul.am_surrogate_moments_cuda(x, w, mu, sg)


def am_surrogate_moments_folded(x: torch.Tensor, w_mean: torch.Tensor,
                                w_var: torch.Tensor):
    """(mean, var) from folded weights w_mean = w(1+mu), w_var = w^2 sg^2
    (``engine.fold_matmul_weights``): x (M,K), weights (K,N). B6 on the card."""
    x, w_mean, w_var = _f32(x, w_mean, w_var)
    if _on(x) == "cpu":
        return ref.am_surrogate_moments_ref(x, w_mean, w_var, MATMUL_CHUNK_K)
    from repro_torch.kernels import am_surrogate_matmul

    return am_surrogate_matmul.am_surrogate_moments_folded_cuda(x, w_mean, w_var)


def am_surrogate_matmul_epilogue(x: torch.Tensor, w_mean: torch.Tensor,
                                 w_var: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """out = x @ w_mean + z * sqrt(max((x*x) @ w_var, 0)), one launch of B5
    on the card.

    x (M,K) or (P,M,K); w_mean/w_var (K,N) or (P,K,N); z (M,N), the caller's
    common-random-numbers draw, shared across P. The output has the
    population axis iff the weights do.
    """
    x, w_mean, w_var, z = _f32(x, w_mean, w_var, z)
    if _on(x) == "cpu":
        return ref.am_surrogate_epilogue_ref(x, w_mean, w_var, z, MATMUL_CHUNK_K)
    from repro_torch.kernels import am_surrogate_matmul

    return am_surrogate_matmul.am_surrogate_matmul_epilogue_cuda(x, w_mean, w_var, z)


def am_surrogate_matmul(x: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
                        sg: torch.Tensor, key: int) -> torch.Tensor:
    """Noise-complete surrogate AM matmul mean + z*sqrt(max(var, 0)): the
    moments from B7, z drawn from ``key`` for the (M, N) output."""
    mean, var = am_surrogate_moments(x, w, mu, sg)
    z = surrogate.crn_normal(key, mean.shape, mean.device)
    return mean + z * torch.sqrt(torch.clamp(var, min=0.0))

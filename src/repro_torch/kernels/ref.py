"""Plain PyTorch versions of the kernels: the oracles the CUDA kernels must
match, and what the wrappers run for tensors on the CPU.

Every sum here has its order pinned and written down, so that a kernel and
its plain version agree bitwise. Elementwise float32 adds in PyTorch round
each add once, as the kernels' ``__fadd_rn`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import fp32_mul


def _masks(masks, device):
    return fp32_mul.stack_masks(device) if masks is None else masks.to(device)


def am_conv2d_bitexact_ref(x, w, slot_map, masks=None) -> torch.Tensor:
    """Bit-exact interleaved conv2d (NHWC, VALID, stride 1).

    x (B,H,W,Cin) f32, w (F,kh,kw,Cin) f32, slot_map (F,kh,kw) variant ids
    (one per filter tap, shared over Cin), masks: optional (V,3,5) column
    masks (default: the seed alphabet). Returns (B, H-kh+1, W-kw+1, F) f32.

    Order: the output accumulator starts at 0.0; for each tap in (ky, kx)
    row-major order, a tap sum starts at 0.0 and adds the Cin products one
    after another from c = 0, then the tap sum is added to the accumulator.
    """
    masks = _masks(masks, x.device)
    b, h, wd, cin = x.shape
    f, kh, kw, _ = w.shape
    ho, wo = h - kh + 1, wd - kw + 1
    slot = torch.as_tensor(slot_map, dtype=torch.int64).to(x.device)
    acc = torch.zeros((b, ho, wo, f), dtype=torch.float32, device=x.device)
    for ky in range(kh):
        for kx in range(kw):
            patch = x[:, ky:ky + ho, kx:kx + wo, :]
            m = masks[slot[:, ky, kx]][:, None]  # (F, 1, 3, 5)
            prods = fp32_mul.fp32_multiply_masks(
                patch[..., None, :], w[:, ky, kx, :], m)  # (B, ho, wo, F, Cin)
            tap = torch.zeros_like(acc)
            for c in range(cin):
                tap = tap + prods[..., c]
            acc = acc + tap
    return acc


def am_matmul_bitexact_ref(x, w, variant_ids, chunk_m: int = 8,
                           chunk_k: int | None = None, masks=None) -> torch.Tensor:
    """Bit-exact AM matmul: x (M,K) f32 @ w (K,N) f32, variant ids (K,N).

    Order: the accumulator starts at 0.0; k runs in blocks of ``chunk_k``
    (one block of K when None); a block sum starts at 0.0 and adds its
    products one after another in k order, then is added to the accumulator.
    ``chunk_m`` only bounds memory (rows are independent).
    """
    masks = _masks(masks, x.device)
    m, k = x.shape
    n = w.shape[1]
    ck = chunk_k or k
    mk = masks[torch.as_tensor(variant_ids, dtype=torch.int64).to(x.device)]
    outs = []
    for i in range(0, m, chunk_m):
        xb = x[i:i + chunk_m]
        prods = fp32_mul.fp32_multiply_masks(xb[:, :, None], w[None], mk[None])
        acc = torch.zeros((xb.shape[0], n), dtype=torch.float32, device=x.device)
        for k0 in range(0, k, ck):
            blk = torch.zeros_like(acc)
            for kk in range(k0, min(k0 + ck, k)):
                blk = blk + prods[:, kk]
            acc = acc + blk
        outs.append(acc)
    return torch.cat(outs, dim=0)


def fp32_multiply_stacked_ref(a, b, masks, chunk: int = 1 << 16) -> torch.Tensor:
    """(V, n) products of a, b (n,) under (V,3,5) masks; the Booth rows are
    built once on the (1, n) operands and broadcast over the V maps.
    ``chunk`` only bounds memory (operands are independent)."""
    outs = [fp32_mul.fp32_multiply_masks(a[None, i:i + chunk], b[None, i:i + chunk],
                                         masks[:, None])
            for i in range(0, a.shape[0], chunk)]
    if not outs:
        return torch.zeros((masks.shape[0], 0), dtype=torch.float32, device=a.device)
    return torch.cat(outs, dim=1)


def conv2d_exact_ref(x, w) -> torch.Tensor:
    """Plain f32 conv2d, NHWC x and (F,kh,kw,Cin) w, VALID, stride 1.

    cuDNN's TF32 is off (set when ``repro_torch`` is imported), so a conv on
    the card is a full float32 conv.
    """
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1)


def am_conv2d_surrogate_ref(x, w, slot_map, z, noise_scale: float = 1.0,
                            moment_tables=None) -> torch.Tensor:
    """Surrogate interleaved conv2d with the noise ``z`` given.

    Each (f, ky, kx) tap's products get (1 + mu_v) mean scaling and an
    additive variance (x^2 conv (w^2 sigma_v^2)); out = mean + z*sqrt(var).
    ``moment_tables`` is a (mu, sigma) pair of per-variant tables (default:
    the calibrated seed tables of x's device).
    """
    from repro_torch.core import surrogate

    if moment_tables is None:
        moment_tables = surrogate.moment_tables(x.device)
    mu_t, sg_t = (torch.as_tensor(t, dtype=torch.float32, device=x.device) * noise_scale
                  for t in moment_tables)
    slot = torch.as_tensor(slot_map, dtype=torch.int64).to(x.device)
    mu, sg = mu_t[slot][..., None], sg_t[slot][..., None]  # (F, kh, kw, 1)
    mean = conv2d_exact_ref(x, w * (1.0 + mu))
    var = conv2d_exact_ref(x * x, (w * w) * (sg * sg))
    return mean + z * torch.sqrt(torch.clamp(var, min=0.0))


def am_surrogate_moments_ref(x, w_mean, w_var, chunk_k: int = 16):
    """(mean, var) = (x @ w_mean, (x*x) @ w_var) in the order of B5-B7.

    x (M,K) or (P,M,K), w_mean/w_var (K,N) or (P,K,N), float32; the result
    broadcasts the population axes, (P?, M, N).

    Order: an accumulator starts at 0.0; k runs in blocks of ``chunk_k``; a
    block sum starts at 0.0 and adds its products one after another in k
    order, then is added to the accumulator. Each product and each sum is
    its own rounded float32 op, as in the kernel.
    """
    m, k = x.shape[-2:]
    n = w_mean.shape[-1]
    xq = x * x
    lead = torch.broadcast_shapes(x.shape[:-2], w_mean.shape[:-2])
    mean = torch.zeros(lead + (m, n), dtype=torch.float32, device=x.device)
    var = torch.zeros_like(mean)
    for k0 in range(0, k, chunk_k):
        bm, bv = torch.zeros_like(mean), torch.zeros_like(mean)
        for kk in range(k0, min(k0 + chunk_k, k)):
            bm = bm + x[..., :, kk, None] * w_mean[..., kk, None, :]
            bv = bv + xq[..., :, kk, None] * w_var[..., kk, None, :]
        mean = mean + bm
        var = var + bv
    return mean, var


def am_surrogate_unfolded_ref(x, w, mu, sg, chunk_k: int = 16):
    """(mean, var) from the unfolded weights, as B7 forms them:
    w_mean = w*(1+mu), w_var = (w*w)*(sg*sg), then the pinned order."""
    return am_surrogate_moments_ref(x, w * (1.0 + mu), (w * w) * (sg * sg), chunk_k)


def am_surrogate_epilogue_ref(x, w_mean, w_var, z, chunk_k: int = 16):
    """B5: mean + z*sqrt(max(var, 0)), z (M,N) shared across the population."""
    mean, var = am_surrogate_moments_ref(x, w_mean, w_var, chunk_k)
    return mean + z * torch.sqrt(torch.clamp(var, min=0.0))

"""Model-zoo building blocks of the xLSTM language model (the train/prefill
forms of the reference's ``models/layers.py``), AM-numerics aware.

Every weight projection routes through ``core.amlinear.am_einsum``, so the
paper's interleaved approximate-multiplier numerics is a config switch. The
mLSTM gate projections (``w_i``, ``w_f``) and the sLSTM recurrent products
(``h @ r_*``) stay plain float32 torch ops, as they are plain ``jnp`` ops in
the reference.

Each block provides ``<block>_def(cfg) -> {name: ParamDef}``; the model
materializes its parameters from the same definitions. The decode forms
(one-token state updates) come with serving (ROADMAP A12).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import surrogate
from repro_torch.core.amlinear import am_einsum


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros

    def initialize(self, gen: torch.Generator, dtype, device) -> torch.Tensor:
        """Zeros, or a standard normal draw from ``gen`` scaled by
        1/sqrt(fan_in) in float32, then cast to ``dtype``."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init != "normal":
            raise ValueError(f"unknown init {self.init!r}")
        fan_in = self.shape[0] if len(self.shape) > 1 else max(self.shape[0], 1)
        scale = 1.0 / math.sqrt(fan_in)
        w = torch.randn(self.shape, generator=gen, dtype=torch.float32, device=device)
        return (w * scale).to(dtype)


def _nkey(key, i: int):
    return None if key is None else surrogate.fold_in(key, i)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + w): the square in x's dtype, its
    mean in float32, the scale cast back to x's dtype."""
    var = (x * x).float().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * (1.0 + w)


def _log_sigmoid(a: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-a)


# ---------------------------------------------------------------------------
# xLSTM blocks (mLSTM matrix memory + sLSTM scalar memory)
# ---------------------------------------------------------------------------


def mlstm_def(cfg) -> dict[str, ParamDef]:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    return {
        "wq": ParamDef((d, h, dh)),
        "wk": ParamDef((d, h, dh)),
        "wv": ParamDef((d, h, dh)),
        "w_i": ParamDef((d, h)),
        "w_f": ParamDef((d, h)),
        "w_o": ParamDef((d, h, dh)),
        "wo": ParamDef((h, dh, d)),
    }


def mlstm_block(p, x: torch.Tensor, cfg, key=None) -> torch.Tensor:
    """mLSTM, C_t = f C + i v k^T (a matrix memory per head), in the
    chunkwise-recurrent train/prefill form: quadratic within chunks of
    ``cfg.scan_chunk`` positions, a (C, n, m) state carried across chunks,
    stabilized in log space."""
    nc = cfg.numerics
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    q = am_einsum("bsd,dhk->bshk", x, p["wq"], cfg=nc, key=_nkey(key, 0))
    k = am_einsum("bsd,dhk->bshk", x, p["wk"], cfg=nc, key=_nkey(key, 1))
    v = am_einsum("bsd,dhk->bshk", x, p["wv"], cfg=nc, key=_nkey(key, 2))
    k = k / math.sqrt(dh)
    xf = x.float()
    logf = _log_sigmoid(torch.einsum("bsd,dh->bsh", xf, p["w_f"].float()))
    logi = torch.einsum("bsd,dh->bsh", xf, p["w_i"].float())

    L = min(cfg.scan_chunk, s)
    nchunk = -(-s // L)
    pad = nchunk * L - s

    def chunked(t, value=0.0):  # (B, S, ...) -> (nchunk, B, L, ...), padded
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad), value=value)
        return t.reshape((b, nchunk, L) + tuple(t.shape[2:])).movedim(1, 0)

    qs, ks, vs = chunked(q.float()), chunked(k.float()), chunked(v.float())
    lfs = chunked(logf)  # pad: log f = 0 (keep the state)
    lis = chunked(logi, -1e30)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    C = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
    m = torch.full((b, h), -1e30, dtype=torch.float32, device=x.device)
    outs = []
    for qc, kc, vc, lfc, lic in zip(qs, ks, vs, lfs, lis):  # C, n scaled by exp(m)
        Fc = torch.cumsum(lfc, dim=1)  # inclusive decay to t, (B,L,H)
        bu = lic - Fc
        run_max = torch.cummax(bu, dim=1).values
        m_t = torch.maximum(m[:, None] + Fc, Fc + run_max)
        inter_w = torch.exp(m[:, None] + Fc - m_t)
        D = Fc[:, :, None, :] + bu[:, None, :, :] - m_t[:, :, None, :]
        W = torch.where(tri[None, :, :, None], torch.exp(D), 0.0)  # (B,L,L,H)
        Ws = W * torch.einsum("bqhd,bkhd->bqkh", qc, kc)
        num = (inter_w[..., None] * torch.einsum("bqhk,bhkv->bqhv", qc, C)
               + torch.einsum("bqkh,bkhv->bqhv", Ws, vc))
        den_val = inter_w * torch.einsum("bqhk,bhk->bqh", qc, n) + Ws.sum(dim=2)
        den = torch.maximum(den_val.abs(), torch.exp(-m_t))
        outs.append(num / den[..., None])

        F_tot = Fc[:, -1]  # (B,H)
        m_next = torch.maximum(m + F_tot, F_tot + run_max[:, -1])
        carry_w = torch.exp(m + F_tot - m_next)  # (B,H)
        in_w = torch.exp(F_tot[:, None] + bu - m_next[:, None])  # (B,L,H)
        C = carry_w[..., None, None] * C + torch.einsum(
            "blhk,blhv->bhkv", in_w[..., None] * kc, vc)
        n = carry_w[..., None] * n + torch.einsum("blh,blhk->bhk", in_w, kc)
        m = m_next
    out = torch.stack(outs, dim=1).reshape(b, nchunk * L, h, dh)[:, :s]
    og = torch.sigmoid(am_einsum("bsd,dhk->bshk", x, p["w_o"], cfg=nc, key=_nkey(key, 3)))
    return am_einsum("bshk,hkd->bsd", (out * og.float()).to(x.dtype), p["wo"], cfg=nc,
                     key=_nkey(key, 4))


def slstm_def(cfg) -> dict[str, ParamDef]:
    d = cfg.d_model
    return {name: ParamDef((d, d)) for name in
            ("w_z", "w_i", "w_f", "w_o", "r_z", "r_i", "r_f", "r_o", "w_out")}


def slstm_block(p, x: torch.Tensor, cfg, key=None) -> torch.Tensor:
    """sLSTM: a recurrent scalar-memory LSTM with exponential gating, a loop
    over time (the reference's lax.scan). State (c, n, h, m), each (B, d)."""
    nc = cfg.numerics
    b, s, d = x.shape
    gx = [am_einsum("bsd,de->bse", x, p[name], cfg=nc, key=_nkey(key, i)).float()
          for i, name in enumerate(("w_z", "w_i", "w_f", "w_o"))]
    rz, ri, rf, ro = (p[name].float() for name in ("r_z", "r_i", "r_f", "r_o"))
    c = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    n = torch.zeros_like(c)
    hp = torch.zeros_like(c)
    m = torch.full((b, d), -1e30, dtype=torch.float32, device=x.device)
    hs = []
    for t in range(s):
        zt, it, ft, ot = (g[:, t] for g in gx)
        z = torch.tanh(zt + hp @ rz)
        logi = it + hp @ ri
        logf = _log_sigmoid(ft + hp @ rf)
        o = torch.sigmoid(ot + hp @ ro)
        m_new = torch.maximum(logf + m, logi)
        ig = torch.exp(logi - m_new)
        fg = torch.exp(logf + m - m_new)
        c = fg * c + ig * z
        n = fg * n + ig
        hp = o * (c / torch.clamp(n, min=1e-6))
        m = m_new
        hs.append(hp)
    hseq = torch.stack(hs, dim=1).to(x.dtype)  # (B,S,d)
    return am_einsum("bsd,de->bse", hseq, p["w_out"], cfg=nc, key=_nkey(key, 4))

"""AM-aware linear layers: the paper's technique as a numerics mode of every
weight projection.

``am_dense`` / ``am_einsum`` are thin clients of the AM engine
(core/engine.py): ``NumericsConfig`` picks the engine backend and the
tile->variant policy, and any contraction whose weight carries (contracting...,
output...) dims is reshaped to a plain matmul, so every engine backend is
reachable from every projection of a model.

  * mode "exact"     - native matmul in the model dtype (the default)
  * mode "surrogate" - calibrated statistical AM emulation with a per-tile
                       variant map; backend surrogate_torch by default,
                       surrogate_fused for the fused kernel (B5)
  * mode "bitexact"  - bit-level emulation; small validation runs only;
                       backend bitexact_ref by default

Policies (resolved by the engine's canonicalizer): "uniform:<variant>" and
"rr:<K>". The reference's "seq:<name>" and "tiers:<name>" policies come with
serving (ROADMAP A12).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine, surrogate

_MODE_DEFAULT_BACKEND = {
    "exact": "exact",
    "surrogate": "surrogate_torch",
    "bitexact": "bitexact_ref",
}


@dataclasses.dataclass(frozen=True)
class NumericsConfig:
    mode: str = "exact"  # exact | surrogate | bitexact
    policy: str = "uniform:pm_csi"
    tile_k: int = 128
    tile_n: int = 128
    backend: str | None = None  # engine backend override (None = mode default)

    def __post_init__(self):
        if self.mode not in _MODE_DEFAULT_BACKEND:
            raise ValueError(f"unknown numerics mode {self.mode!r}")
        if self.backend is not None and self.backend not in engine.BACKEND_NAMES:
            raise ValueError(f"unknown AM backend {self.backend!r}; have "
                             f"{engine.BACKEND_NAMES}")

    @property
    def engine_backend(self) -> str:
        return self.backend or _MODE_DEFAULT_BACKEND[self.mode]

    @classmethod
    def for_backend(cls, backend: str, policy: str = "uniform:pm_csi",
                    **kw) -> "NumericsConfig":
        """Config from an engine backend name."""
        mode = ("exact" if backend == "exact"
                else "bitexact" if backend.startswith("bitexact")
                else "surrogate")
        return cls(mode=mode, policy=policy, backend=backend, **kw)


EXACT = NumericsConfig(mode="exact")


def am_dense(x: torch.Tensor, w: torch.Tensor, *, cfg: NumericsConfig = EXACT,
             key: int | None = None) -> torch.Tensor:
    """x (..., K) @ w (K, N) under the configured numerics, in x's dtype."""
    if cfg.mode == "exact":
        return x @ w
    y = engine.am_matmul(x, w, cfg.policy, backend=cfg.engine_backend, key=key,
                         tile_k=cfg.tile_k, tile_n=cfg.tile_n)
    return y.to(x.dtype)


def _dense_form(spec: str, x_ndim: int, w_ndim: int):
    """Parse an einsum spec into matmul form: w dims = (contract..., out...),
    x ends with the contract dims, out = x_lead + out dims. Returns
    (n_contract, n_out), or None when the spec does not reduce to a matmul
    (batch dims in w, repeated labels, transposed contractions)."""
    try:
        ins, out = spec.replace(" ", "").split("->")
        xs, ws = ins.split(",")
    except ValueError:
        return None
    if len(xs) != x_ndim or len(ws) != w_ndim:
        return None
    if len(set(xs)) != len(xs) or len(set(ws)) != len(ws):
        return None
    c = "".join(l for l in ws if l in xs and l not in out)
    o = ws[len(c):]
    if not c or ws != c + o:
        return None
    if not xs.endswith(c):
        return None
    lead = xs[: len(xs) - len(c)]
    if out != lead + o or any(l in xs for l in o):
        return None
    return len(c), len(o)


def am_einsum(spec: str, x: torch.Tensor, w: torch.Tensor, *,
              cfg: NumericsConfig = EXACT, key: int | None = None) -> torch.Tensor:
    """Einsum with AM numerics.

    Contractions of the form (lead..., c...) x (c..., o...) -> (lead..., o...),
    every projection of the model zoo, reshape to ``am_dense``, so the
    variant tile map covers the (prod(contract), prod(out)) matmul grid.
    Other specs keep the reference's surrogate moment-einsum fallback, whose
    map covers w's last two dims.
    """
    if cfg.mode == "exact":
        return torch.einsum(spec, x, w)
    form = _dense_form(spec, x.dim(), w.dim())
    if form is not None:
        n_c, _ = form
        k = int(np.prod(w.shape[:n_c]))
        n = int(np.prod(w.shape[n_c:]))
        lead = tuple(x.shape[: x.dim() - n_c])
        y = am_dense(x.reshape(lead + (k,)), w.reshape(k, n), cfg=cfg, key=key)
        return y.reshape(lead + tuple(w.shape[n_c:]))
    if cfg.mode == "surrogate":
        if key is None:
            raise ValueError("surrogate am_einsum draws noise and needs a key")
        k, n = w.shape[-2], w.shape[-1]
        cmap = engine.canonical_matmul_map(cfg.policy, k, n, tile_k=cfg.tile_k,
                                           tile_n=cfg.tile_n)
        mu, sg = engine.device_moment_maps(cmap, device=x.device)
        xf, wf = x.float(), w.float()
        mean = torch.einsum(spec, xf, wf * (1.0 + mu))
        var = torch.einsum(spec, xf * xf, (wf * wf) * (sg * sg))
        z = surrogate.crn_normal(key, mean.shape, mean.device)
        return (mean + z * torch.sqrt(torch.clamp(var, min=0.0))).to(x.dtype)
    raise NotImplementedError(
        f"bitexact einsum for non-matmul spec {spec!r}: use am_dense on 2-D slices")

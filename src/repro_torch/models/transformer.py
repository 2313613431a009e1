"""Decoder-only LM assembly (the reference's ``models/transformer.py``,
forward and loss): config, parameters, embedding, backbone, head.

A layer is (mixer, ffn) drawn from the config's ``pattern``, cycled across
``n_layers``. The port ports the mixers ``mlstm`` and ``slstm`` with
``ffn="none"`` (xLSTM); attention, RG-LRU and the FFNs come with the other
configs (ROADMAP A11).

Parameters are a dict: ``embed`` (V, d), ``head`` (d, V), ``norm_f`` (d,) and
``layers``, one dict per layer in order. The reference stacks the pattern's
repetitions on a leading axis and scans over it; here that axis is unstacked
(``weights.lm_params_from_jax``) and the layers run in a Python loop. The
reference's rematerialization and logical sharding constraints have no
counterpart on one card: they change where values live, not what they are.

Noise keys are integers and follow the reference's fold-in tree: repetition
r of the pattern gets ``fold_in(key, r)``, its layer j ``fold_in(., j)``, the
mixer ``fold_in(., 0)``, each projection ``fold_in(., i)``; tail layer j
gets ``fold_in(key, 10_000 + j)``, the head ``fold_in(key, 99)``.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn

from repro_torch import check_device
from repro_torch.core import surrogate
from repro_torch.core.amlinear import EXACT, NumericsConfig, am_einsum
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0
    pattern: tuple = (("mlstm", "none"),)
    scan_chunk: int = 256
    numerics: NumericsConfig = EXACT
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def n_rep(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_tail(self) -> int:
        return self.n_layers % len(self.pattern)

    def with_numerics(self, numerics: NumericsConfig) -> "ModelConfig":
        return dataclasses.replace(self, numerics=numerics)

    def layer_kinds(self) -> list[tuple[str, str]]:
        """(mixer, ffn) of every layer in order: the pattern's repetitions,
        then the tail."""
        return list(self.pattern) * self.n_rep + list(self.pattern[:self.n_tail])


MIXER_DEFS = {"mlstm": L.mlstm_def, "slstm": L.slstm_def}
MIXERS = {"mlstm": L.mlstm_block, "slstm": L.slstm_block}


def _layer_defs(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    if mixer not in MIXER_DEFS or ffn != "none":
        raise NotImplementedError(
            f"layer ({mixer}, {ffn}) is not ported (ROADMAP A11); the port has the "
            f"mixers {sorted(MIXER_DEFS)} with ffn='none'")
    return {"ln1": L.ParamDef((cfg.d_model,), "zeros"), "mixer": MIXER_DEFS[mixer](cfg)}


def param_defs(cfg: ModelConfig) -> dict:
    return {
        "embed": L.ParamDef((cfg.vocab, cfg.d_model)),
        "head": L.ParamDef((cfg.d_model, cfg.vocab)),
        "norm_f": L.ParamDef((cfg.d_model,), "zeros"),
        "layers": [_layer_defs(cfg, m, f) for m, f in cfg.layer_kinds()],
    }


def _map_defs(fn, d):
    if isinstance(d, L.ParamDef):
        return fn(d)
    if isinstance(d, list):
        return [_map_defs(fn, v) for v in d]
    return {k: _map_defs(fn, v) for k, v in d.items()}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from one ``torch.Generator`` on ``device`` seeded
    with ``seed``, drawn leaf by leaf in definition order, in cfg's dtype."""
    dev = check_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return _map_defs(lambda d: d.initialize(gen, cfg.torch_dtype, dev), param_defs(cfg))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _k(key, i: int):
    return None if key is None else surrogate.fold_in(key, i)


def _apply_layer(p, x, cfg, mixer: str, key):
    h = L.rms_norm(x, p["ln1"])
    return x + MIXERS[mixer](p["mixer"], h, cfg, key=_k(key, 0))


def backbone(params, x: torch.Tensor, cfg: ModelConfig, key=None) -> torch.Tensor:
    """Embedded inputs (B, S, d) -> final hidden states (B, S, d)."""
    per = len(cfg.pattern)
    for i, (mixer, _) in enumerate(cfg.layer_kinds()):
        r, j = divmod(i, per)
        k = _k(_k(key, r), j) if r < cfg.n_rep else _k(key, 10_000 + j)
        x = _apply_layer(params["layers"][i], x, cfg, mixer, k)
    return L.rms_norm(x, params["norm_f"])


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens]
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)


def lm_logits(params, h: torch.Tensor, cfg: ModelConfig, key=None) -> torch.Tensor:
    return am_einsum("bsd,dv->bsv", h, params["head"], cfg=cfg.numerics, key=key)


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)


def forward(params, batch, cfg: ModelConfig, key=None) -> torch.Tensor:
    """batch: {"tokens": (B, S) ints} -> logits (B, S, V) in cfg's dtype."""
    dev = params["embed"].device
    x = embed_tokens(params, _tensor(batch["tokens"], dev), cfg)
    h = backbone(params, x, cfg, key=key)
    return lm_logits(params, h, cfg, key=_k(key, 99))


def loss_fn(params, batch, cfg: ModelConfig, key=None) -> torch.Tensor:
    """Causal-LM cross entropy with a z-loss stabilizer (a float32 scalar)."""
    logits = forward(params, batch, cfg, key=key).float()
    labels = _tensor(batch["labels"], logits.device)
    mask = (labels >= 0).float()
    labels = torch.clamp(labels, min=0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    zloss = 1e-4 * (lse * mask) ** 2
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll.sum() + zloss.sum()) / denom


class DecoderLM(nn.Module):
    """The LM as an ``nn.Module`` on one device, in cfg's dtype: its
    parameters (``init_params`` or carried from the reference) as frozen
    ``nn.Parameter``s, ``forward`` and ``loss`` over a token batch."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        frozen = functools.partial(nn.Parameter, requires_grad=False)
        self.embed = frozen(params["embed"])
        self.head = frozen(params["head"])
        self.norm_f = frozen(params["norm_f"])
        self.layers = nn.ModuleList()
        for lp in params["layers"]:
            layer = nn.Module()
            layer.ln1 = frozen(lp["ln1"])
            layer.mixer = nn.ParameterDict({k: frozen(v) for k, v in lp["mixer"].items()})
            self.layers.append(layer)

    def params(self) -> dict:
        """The parameter dict that ``forward``/``loss_fn`` take."""
        return {"embed": self.embed, "head": self.head, "norm_f": self.norm_f,
                "layers": [{"ln1": l.ln1, "mixer": dict(l.mixer)} for l in self.layers]}

    def forward(self, batch, key=None) -> torch.Tensor:
        return forward(self.params(), batch, self.cfg, key=key)

    def loss(self, batch, key=None) -> torch.Tensor:
        return loss_fn(self.params(), batch, self.cfg, key=key)

"""The paper's CNN (Sec. III): two conv layers, 10 + 12 kernels of 3x3.

conv1(10 @ 3x3) -> relu -> maxpool 2x2 -> conv2(12 @ 3x3) -> relu ->
maxpool 2x2 -> dense(10). Approximate multipliers act only inside the
convolutions ("exact multipliers used elsewhere"): the dense head is always
exact.

Activations are NHWC and conv weights (F, kh, kw, Cin), as in the JAX
package. Inference numerics are an ``AMConfig``: an engine backend plus the
per-layer slot maps ([(10,3,3), (12,3,3)] variant ids, 198 slots).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core import engine, interleave, surrogate

LAYER_FILTERS = [10, 12]
N_SLOTS = sum(f * 9 for f in LAYER_FILTERS)  # 198, paper Sec. III-A
PARAM_NAMES = ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "dense_w", "dense_b")


@dataclasses.dataclass(frozen=True)
class AMConfig:
    """CNN inference numerics: an engine backend + per-layer slot maps.

    backend: core/engine.py backend name ("exact" ignores the maps).
    slot_maps: per-layer (F, 3, 3) variant-id arrays, or None for exact.
    noise_scale: moment amplification (surrogate backends only).
    """

    backend: str = "exact"
    slot_maps: tuple | None = None
    noise_scale: float = 1.0

    @classmethod
    def from_sequence(cls, seq, backend: str = "surrogate_torch",
                      noise_scale: float = 1.0) -> "AMConfig":
        """Build from a flat 198-slot variant sequence."""
        maps = slot_maps_from_sequence(np.asarray(seq, np.int32))
        return cls(backend, tuple(np.asarray(m, np.int32) for m in maps), noise_scale)

    @classmethod
    def coerce(cls, numerics) -> "AMConfig":
        if isinstance(numerics, AMConfig):
            return numerics
        if numerics is None or numerics == "exact":
            return EXACT
        raise ValueError(f"unknown numerics {numerics!r}; pass an AMConfig")

    @property
    def is_exact(self) -> bool:
        return self.backend == "exact" or self.slot_maps is None

    @property
    def needs_key(self) -> bool:
        return not self.is_exact and self.backend.startswith("surrogate")


EXACT = AMConfig()


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x2 max pool, stride 2, VALID (an odd last row/column drops)."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2, :]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class PaperCNN(nn.Module):
    """The paper's CNN over a params dict in the JAX package's layouts."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        for name in PARAM_NAMES:
            setattr(self, name, nn.Parameter(params[name].float(), requires_grad=False))

    def _conv(self, x, layer: int, cfg: AMConfig, key):
        w = getattr(self, f"conv{layer}_w")
        b = getattr(self, f"conv{layer}_b")
        if cfg.is_exact:
            y = engine.am_conv2d(x, w)
        else:
            y = engine.am_conv2d(x, w, cfg.slot_maps[layer - 1], backend=cfg.backend,
                                 key=key, noise_scale=cfg.noise_scale)
        return y + b

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The exact dense head on pooled (B, 6, 6, 12) features."""
        return h.reshape(h.shape[0], -1) @ self.dense_w + self.dense_b

    def features(self, x, numerics="exact", key=None) -> torch.Tensor:
        """Pooled conv features (B, 6, 6, 12) of x (B, 32, 32, 3) in [0, 1]."""
        cfg = AMConfig.coerce(numerics)
        keys = (None, None)
        if cfg.needs_key:
            if key is None:
                raise ValueError("surrogate numerics needs a noise key")
            keys = (surrogate.fold_in(key, 0), surrogate.fold_in(key, 1))
        h = maxpool2(torch.relu(self._conv(x, 1, cfg, keys[0])))
        return maxpool2(torch.relu(self._conv(h, 2, cfg, keys[1])))

    def forward(self, x, numerics="exact", key=None) -> torch.Tensor:
        """(B, 10) logits; numerics an AMConfig (or "exact"), key an int."""
        return self.head(self.features(x, numerics, key))


def accuracy(model: PaperCNN, x: torch.Tensor, y: torch.Tensor, numerics="exact",
             key=None, chunk: int = 8) -> float:
    """Classification accuracy under the given numerics, in image chunks.

    The plain bit-exact version (``bitexact_ref``, or any bit-exact backend
    on the CPU) keeps ``chunk`` images a call, since it holds int64 words
    per product; the CUDA kernel and the other backends take 256 at least.
    """
    cfg = AMConfig.coerce(numerics)
    plain_bitexact = cfg.backend.startswith("bitexact") and (
        cfg.backend == "bitexact_ref" or x.device.type == "cpu")
    if not plain_bitexact:
        chunk = max(chunk, 256)
    base_key = 0 if key is None else key
    correct = 0
    with torch.no_grad():
        for i in range(0, x.shape[0], chunk):
            pred = model(x[i:i + chunk], cfg, key=surrogate.fold_in(base_key, i))
            correct += int((pred.argmax(-1) == y[i:i + chunk]).sum())
    return correct / x.shape[0]


def slot_maps_from_sequence(seq):
    """Flat 198-slot sequence -> [map1 (10,3,3), map2 (12,3,3)]."""
    return interleave.conv_slot_map(seq, LAYER_FILTERS)

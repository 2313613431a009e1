"""Architecture registry (the reference's ``models/registry.py``, the part
the port has): arch specs and step-function dispatch for the decoder-only
LMs. The port carries ``xlstm-125m``; the other configs and the
encoder-decoder model come with ROADMAP A11.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

from repro_torch.models import transformer
from repro_torch.models.transformer import ModelConfig

ARCH_IDS = ("xlstm-125m",)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    config: ModelConfig
    smoke: ModelConfig


def get(name: str) -> ArchSpec:
    if name not in ARCH_IDS:
        raise ValueError(f"arch {name!r} is not ported (ROADMAP A11); have {ARCH_IDS}")
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}").SPEC


def forward_fn(cfg: ModelConfig) -> Callable:
    return transformer.forward


def loss_fn(cfg: ModelConfig) -> Callable:
    return transformer.loss_fn


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    return transformer.init_params(cfg, seed, device)

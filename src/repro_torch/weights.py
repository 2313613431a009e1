"""Carry parameters across from the JAX package's numpy form."""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(params: dict[str, np.ndarray], device="cuda") -> dict[str, torch.Tensor]:
    """A params dict of numpy arrays -> float32 tensors on ``device``, in the
    same layouts ((F, kh, kw, Cin) conv weights, (K, N) dense weights)."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in params.items()}


def lm_params_from_jax(tree, cfg, device="cuda") -> dict[str, object]:
    """The reference LM's parameter tree, as numpy, in the port's layout on
    ``device`` and in cfg's dtype: the ``blocks`` axis (the pattern's n_rep
    repetitions) is unstacked into one dict per layer, in order, followed by
    the ``tail`` layers."""
    dt = cfg.torch_dtype

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=dt)

    def layer(p, idx=None):
        sel = (lambda a: a[idx]) if idx is not None else (lambda a: a)
        return {"ln1": t(sel(p["ln1"])),
                "mixer": {k: t(sel(v)) for k, v in p["mixer"].items()}}

    layers = [layer(tree["blocks"][f"l{j}"], r) for r in range(cfg.n_rep)
              for j in range(len(cfg.pattern))]
    layers += [layer(tree["tail"][f"t{j}"]) for j in range(cfg.n_tail)]
    return {"embed": t(tree["embed"]), "head": t(tree["head"]),
            "norm_f": t(tree["norm_f"]), "layers": layers}


def to_device(tree, device):
    """A parameter tree (dicts and lists of tensors) moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return {k: to_device(v, device) for k, v in tree.items()}

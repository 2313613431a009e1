"""Carry parameters across from the JAX package's numpy form."""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(params: dict[str, np.ndarray], device="cuda") -> dict[str, torch.Tensor]:
    """A params dict of numpy arrays -> float32 tensors on ``device``, in the
    same layouts ((F, kh, kw, Cin) conv weights, (K, N) dense weights)."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in params.items()}

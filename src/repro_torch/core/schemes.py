"""Interleaving schemes: (stage, column) -> compressor-code maps.

The compressor tree has 3 reduction stages over 48 columns. Approximate
compressors occupy columns 0..23; columns 24..47 stay exact.

The nine seed variants: id 0 is the exact multiplier, ids 1..8 the paper's
eight FP32 AMs. PM* lean positive (PC-dominant), NM* lean negative, with the
interleave pattern NI (one type), SI (per-stage alternation), CI (per-column
alternation) or CSI (stage+column checkerboard).

A scheme map is an int32 (3, 48) numpy array of compressor codes. The port
holds the seed alphabet only; runtime registration of further variants is
not part of it.
"""
from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.core import compressors as C

N_STAGES = 3
N_COLS = 48
APPROX_COLS = 24  # columns [0, 24) are approximate

SEED_VARIANTS = (
    "exact",
    "pm_ni",
    "pm_si",
    "pm_ci",
    "pm_csi",
    "nm_ni",
    "nm_si",
    "nm_ci",
    "nm_csi",
)
VARIANTS = SEED_VARIANTS
AM_VARIANTS = SEED_VARIANTS[1:]
VARIANT_IDS = {v: i for i, v in enumerate(SEED_VARIANTS)}
N_VARIANTS = len(SEED_VARIANTS)


def _seed_map(variant: str) -> np.ndarray:
    """A seed variant's (3, 48) map from the paper's pattern."""
    m = np.full((N_STAGES, N_COLS), C.EXACT, dtype=np.int32)
    if variant == "exact":
        return m
    s = np.arange(N_STAGES)[:, None]
    c = np.arange(N_COLS)[None, :]
    approx = c < APPROX_COLS
    pc, nc = C.PC1, C.NC1
    if variant == "pm_ni":
        fill = np.where(approx, pc, C.EXACT)
    elif variant == "nm_ni":
        fill = np.where(approx, nc, C.EXACT)
    elif variant == "pm_si":
        fill = np.where(approx, np.where(s % 2 == 0, pc, nc), C.EXACT)
    elif variant == "nm_si":
        fill = np.where(approx, np.where(s % 2 == 0, nc, pc), C.EXACT)
    elif variant == "pm_ci":
        fill = np.where(approx, np.where(c % 2 == 0, pc, nc), C.EXACT)
    elif variant == "nm_ci":
        fill = np.where(approx, np.where(c % 2 == 0, nc, pc), C.EXACT)
    elif variant == "pm_csi":
        fill = np.where(approx, np.where((s + c) % 2 == 0, pc, nc), C.EXACT)
    elif variant == "nm_csi":
        fill = np.where(approx, np.where((s + c) % 2 == 0, nc, pc), C.EXACT)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return np.broadcast_to(fill, (N_STAGES, N_COLS)).astype(np.int32)


_MAPS = {v: _seed_map(v) for v in SEED_VARIANTS}
_STACK = np.stack([_MAPS[v] for v in SEED_VARIANTS])
_STACK.setflags(write=False)


def validate_scheme_map(m) -> np.ndarray:
    """Validate and canonicalize a (3, 48) compressor-code map."""
    arr = np.asarray(m)
    if arr.shape != (N_STAGES, N_COLS):
        raise ValueError(f"scheme map shape {arr.shape} != ({N_STAGES}, {N_COLS})")
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"scheme map dtype {arr.dtype} is not integral")
    if arr.min() < 0 or arr.max() >= C.N_COMPRESSORS:
        raise ValueError(
            f"scheme map codes must be in [0, {C.N_COMPRESSORS}); "
            f"got range [{arr.min()}, {arr.max()}]")
    return arr.astype(np.int32, copy=True)


def scheme_map(variant: str) -> np.ndarray:
    """The (3, 48) compressor-code map of a seed variant (a copy)."""
    try:
        return _MAPS[variant].copy()
    except KeyError:
        raise ValueError(f"unknown variant {variant!r}") from None


def scheme_stack() -> np.ndarray:
    """(N_VARIANTS, 3, 48) stack of the variant maps, indexed by variant id."""
    return _STACK


def registry_signature() -> bytes:
    """Content hash of the alphabet (names + maps, id order).

    The same bytes as the JAX package's signature of its seed alphabet, so
    memo keys salted with it name the same alphabet in both packages.
    """
    h = hashlib.sha1()
    for name in SEED_VARIANTS:
        h.update(name.encode())
        h.update(_MAPS[name].tobytes())
    return h.digest()

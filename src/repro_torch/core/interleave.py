"""Multiplier-slot variant maps: the paper's interleaving mechanism.

Conv slots are (filter, kh, kw) positions: the paper's CNN has
(10 + 12) filters x 3x3 = 198 slots, one AM variant per slot, shared across
input channels. Sequences are int arrays of variant ids (0 exact, 1..8 the
paper's AMs in ``schemes.VARIANTS`` order).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import schemes


def conv_slot_map(sequence, layer_filters: list[int], kh: int = 3, kw: int = 3):
    """Split a flat slot sequence into per-layer (F, kh, kw) variant maps."""
    seq = np.asarray(sequence, np.int32).ravel()
    total = sum(f * kh * kw for f in layer_filters)
    if seq.size != total:
        raise ValueError(f"sequence length {seq.size} != total slots {total}")
    maps, off = [], 0
    for f in layer_filters:
        n = f * kh * kw
        maps.append(seq[off:off + n].reshape(f, kh, kw))
        off += n
    return maps


def uniform_sequence(variant: str, n_slots: int) -> np.ndarray:
    return np.full(n_slots, schemes.VARIANT_IDS[variant], np.int32)


def random_displacement(sequence, rng: np.random.Generator) -> np.ndarray:
    """Random permutation of slot positions, keeping the variant multiset
    (paper Fig. 5: placement sensitivity of an NSGA-II sequence)."""
    return rng.permutation(np.asarray(sequence, np.int32))


def alphabet_for_k(k: int) -> list[int]:
    """The paper's accuracy-ranked alphabet: the top-K AMs by uniform-CNN
    accuracy (Fig. 2a: PMCSI, NMSI, NMCSI, NMNI, PMSI, PMCI, PMNI, NMCI)."""
    order = ["pm_csi", "nm_si", "nm_csi", "nm_ni", "pm_si", "pm_ci", "pm_ni", "nm_ci"]
    return [schemes.VARIANT_IDS[v] for v in order[:k]]

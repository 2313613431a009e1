"""Seekable deterministic token stream (no external data offline); a copy
of the reference's ``data/synthetic.py`` token batches.

Batches are a pure function of (seed, step). The stream is a mixture of
n-gram Markov chains so a small LM has learnable structure rather than
uniform noise.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng((np.uint64(seed) << np.uint64(32)) ^ np.uint64(step))


def lm_batch(step: int, *, global_batch: int, seq: int, vocab: int, seed: int = 0):
    """tokens/labels (B, S) int32; labels are next-token shifted."""
    rng = _rng(seed, step)
    b = global_batch
    # Markov chain per sequence: next = (a*cur + c) % V with occasional noise.
    a = rng.integers(1, 64, (b, 1))
    c = rng.integers(0, vocab, (b, 1))
    x = np.empty((b, seq + 1), np.int64)
    x[:, 0] = rng.integers(0, vocab, b)
    noise = rng.random((b, seq)) < 0.1
    rand = rng.integers(0, vocab, (b, seq))
    for t in range(seq):
        nxt = (a[:, 0] * x[:, t] + c[:, 0]) % vocab
        x[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
    return {
        "tokens": x[:, :-1].astype(np.int32),
        "labels": x[:, 1:].astype(np.int32),
    }


def batch_for(cfg, step: int, *, global_batch: int, seq: int, seed: int = 0):
    """The batch of an arch config. The port's configs are text-only; the
    reference's multimodal stub batches come with their configs (ROADMAP A11)."""
    return lm_batch(step, global_batch=global_batch, seq=seq, vocab=cfg.vocab, seed=seed)

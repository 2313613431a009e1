"""Deterministic procedural CIFAR-10 stand-in (no network access offline).

10 classes of 32x32x3 images in [0, 1]. Each class is a parametric family —
class-dependent grating orientation/frequency, hue, and shape overlay — plus
instance noise, so a small CNN reaches CIFAR-like accuracy (paper: 77 % train
/ 59.8 % exact-inference test) without being trivially separable.

Generation is pure-numpy, seeded by (split, index): any subset is
reproducible and seekable. (The JAX package's numpy module, copied so the
port imports nothing of it.)
"""
from __future__ import annotations

import numpy as np

NUM_CLASSES = 10
IMG = 32

_SPLIT_SEEDS = {"train": 0x5EED, "test": 0x7E57}


def _batch_rng(split: str, start: int) -> np.random.Generator:
    return np.random.default_rng((_SPLIT_SEEDS[split] << 32) ^ start)


def make_batch(split: str, start: int, n: int):
    """Images (n, 32, 32, 3) f32 and labels (n,) i32 for indices [start, start+n).

    Tuned so the paper's 2-conv CNN lands near its CIFAR-10 operating point
    (~60 % exact-inference test accuracy): class orientations are spaced only
    18 deg apart with +-9 deg instance jitter (neighbor overlap), contrast is
    heavily jittered, the hue cue is weak, the shape overlay is a class-
    independent distractor, and pixel noise is strong.
    """
    rng = _batch_rng(split, start)
    idx = np.arange(start, start + n)
    labels = (idx * 7 + (3 if split == "test" else 0)) % NUM_CLASSES

    yy, xx = np.mgrid[0:IMG, 0:IMG].astype(np.float32) / IMG  # (32,32)

    # Orientation: 18 deg class spacing, +-16 deg jitter -> adjacent classes
    # genuinely overlap.
    theta = labels * (np.pi / NUM_CLASSES) + rng.uniform(
        -np.pi / 11, np.pi / 11, n
    ).astype(np.float32)
    freq = 2.5 + (labels % 5) * 0.9 + rng.uniform(-0.9, 0.9, n).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, n).astype(np.float32)

    cs, sn = np.cos(theta), np.sin(theta)
    proj = cs[:, None, None] * xx[None] + sn[:, None, None] * yy[None]
    grating = 0.5 + 0.5 * np.sin(
        2 * np.pi * freq[:, None, None] * proj + phase[:, None, None]
    )

    # Weak hue cue with heavy jitter.
    hues = np.linspace(0.0, 1.0, NUM_CLASSES, endpoint=False)
    base = np.stack(
        [
            0.5 + 0.5 * np.cos(2 * np.pi * (hues + s))
            for s in (0.0, 1.0 / 3.0, 2.0 / 3.0)
        ],
        axis=-1,
    )  # (10, 3)
    color = base[labels] + rng.normal(0, 0.55, (n, 3)).astype(np.float32)

    # Distractor shape: kind/center/size independent of the label.
    cx = rng.uniform(0.2, 0.8, n).astype(np.float32)
    cy = rng.uniform(0.2, 0.8, n).astype(np.float32)
    r = rng.uniform(0.08, 0.2, n).astype(np.float32)
    kind = rng.integers(0, 3, n)
    dx = xx[None] - cx[:, None, None]
    dy = yy[None] - cy[:, None, None]
    dist_c = np.sqrt(dx * dx + dy * dy)
    dist_s = np.maximum(np.abs(dx), np.abs(dy))
    dist_d = np.abs(dx) + np.abs(dy)
    dist = np.where(
        (kind == 0)[:, None, None],
        dist_c,
        np.where((kind == 1)[:, None, None], dist_s, dist_d),
    )
    mask = (dist < r[:, None, None]).astype(np.float32)

    contrast = rng.uniform(0.15, 0.5, n).astype(np.float32)[:, None, None, None]
    img = contrast * (
        0.8 * grating[..., None] * (0.4 + 0.6 * color[:, None, None, :])
        + 0.5 * mask[..., None]
    )
    img += 0.25 + rng.normal(0, 0.33, img.shape).astype(np.float32)
    img = np.clip(img, 0.0, 1.0).astype(np.float32)
    return img, labels.astype(np.int32)

"""Procedural image classification dataset (port of ``repro.data.vision``,
the offline CIFAR stand-in).

Classes are parametric texture/shape generators — oriented stripes, checkers,
radial blobs, gradients, crosses, rings, noise scales — rendered at 32x32x3
with per-sample jitter (phase, frequency, color, noise).  10-class mode uses
the 10 base generators; 100-class mode crosses them with 10 color/frequency
variants (the CIFAR-100-is-harder analogue: same budget, finer classes).

Deterministic per (split, index): restart-safe, no storage.  Pure numpy, the
same generator calls in the same order as the reference, so images and
labels are byte-equal to its.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    num_classes: int = 10
    img_size: int = 32
    seed: int = 0


def _grid(n):
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) / n
    return x, y


def _base_pattern(kind: int, x, y, rng) -> np.ndarray:
    f = 2 + rng.integers(0, 3)
    ph = rng.random() * 2 * np.pi
    if kind == 0:  # horizontal stripes
        return np.sin(2 * np.pi * f * y + ph)
    if kind == 1:  # vertical stripes
        return np.sin(2 * np.pi * f * x + ph)
    if kind == 2:  # diagonal stripes
        return np.sin(2 * np.pi * f * (x + y) / np.sqrt(2) + ph)
    if kind == 3:  # checkerboard
        return np.sign(np.sin(2 * np.pi * f * x + ph) * np.sin(2 * np.pi * f * y + ph))
    if kind == 4:  # radial blob
        cx, cy = 0.3 + 0.4 * rng.random(2)
        r = np.hypot(x - cx, y - cy)
        return np.exp(-((r * (3 + f)) ** 2)) * 2 - 1
    if kind == 5:  # ring
        cx, cy = 0.35 + 0.3 * rng.random(2)
        r = np.hypot(x - cx, y - cy)
        return np.cos(2 * np.pi * f * r + ph)
    if kind == 6:  # gradient
        ang = rng.random() * 2 * np.pi
        return 2 * (np.cos(ang) * x + np.sin(ang) * y) - 1
    if kind == 7:  # cross
        cx, cy = 0.3 + 0.4 * rng.random(2)
        w = 0.06 + 0.04 * rng.random()
        return ((np.abs(x - cx) < w) | (np.abs(y - cy) < w)).astype(np.float64) * 2 - 1
    if kind == 8:  # square patch
        cx, cy = 0.25 + 0.4 * rng.random(2)
        s = 0.15 + 0.1 * rng.random()
        return ((np.abs(x - cx) < s) & (np.abs(y - cy) < s)).astype(np.float64) * 2 - 1
    # kind == 9: band-limited noise texture
    coarse = rng.standard_normal((4 + f, 4 + f))
    reps = -(-x.shape[0] // coarse.shape[0])
    img = np.kron(coarse, np.ones((reps, reps)))[: x.shape[0], : x.shape[1]]
    return img / max(np.abs(img).max(), 1e-6)


def make_sample(cfg: VisionConfig, split: str, index: int):
    """-> (img (H, W, 3) float32 in [0, 1], label int)."""
    salt = {"train": 0, "test": 1_000_000_007}[split]
    rng = np.random.default_rng(cfg.seed * 77_003 + salt + index)
    label = int(rng.integers(0, cfg.num_classes))
    if cfg.num_classes <= 10:
        kind, variant = label, label  # color mapping tied to the class
    else:  # 100-class: (pattern, variant) product
        kind, variant = label % 10, label // 10
    x, y = _grid(cfg.img_size)
    base = _base_pattern(kind, x, y, rng)
    # variant controls the color mapping (class-defining); per-sample jitter
    vr = np.random.default_rng(cfg.seed * 13 + variant)
    color_pos = 0.25 + 0.75 * vr.random(3)
    color_neg = 0.25 + 0.75 * vr.random(3)
    jitter = 1.0 + rng.normal(0, 0.08, 3)
    img = np.empty((cfg.img_size, cfg.img_size, 3))
    t = (base + 1) / 2
    for c in range(3):
        img[..., c] = (t * color_pos[c] + (1 - t) * color_neg[c]) * jitter[c]
    img += rng.standard_normal(img.shape) * 0.06
    return np.clip(img, 0, 1).astype(np.float32), label


def make_vision_dataset(cfg: VisionConfig, split: str, n: int):
    """-> (images (n, H, W, 3), labels (n,))."""
    imgs = np.empty((n, cfg.img_size, cfg.img_size, 3), np.float32)
    labels = np.empty((n,), np.int32)
    for i in range(n):
        imgs[i], labels[i] = make_sample(cfg, split, i)
    return imgs, labels

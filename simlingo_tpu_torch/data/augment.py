"""Image augmentation for training.

Port copy of `simlingo_tpu/data/augment.py`.

Behavioral counterpart of reference `dataset_base.py:image_augmenter`
(imgaug Sequential, each op applied with probability `prob`): gaussian blur,
additive gaussian noise, coarse dropout, per-channel multiply, linear
contrast, partial grayscale. Implemented with numpy/cv2 and an explicit
RandomState so augmentation is deterministic per (seed, sample).
Also includes the base stack's CLAHE/hist-eq enhancement
(simlingo_base_training/utils/image_enhancing.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    import cv2
    if sigma <= 0:
        return img
    k = max(int(sigma * 4) | 1, 3)
    return cv2.GaussianBlur(img, (k, k), sigma)


def additive_gaussian_noise(img: np.ndarray, scale: float, rng,
                            per_channel: bool) -> np.ndarray:
    shape = img.shape if per_channel else img.shape[:2] + (1,)
    noise = rng.normal(0, scale, shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def coarse_dropout(img: np.ndarray, frac: float, rng) -> np.ndarray:
    out = img.copy()
    h, w = img.shape[:2]
    n = int(frac * h * w / 64)
    for _ in range(n):
        y, x = rng.randint(h - 8), rng.randint(w - 8)
        out[y:y + 8, x:x + 8] = 0
    return out


def multiply(img: np.ndarray, factor, rng, per_channel: bool) -> np.ndarray:
    if per_channel:
        f = rng.uniform(*factor, size=(1, 1, img.shape[2]))
    else:
        f = rng.uniform(*factor)
    return np.clip(img.astype(np.float32) * f, 0, 255).astype(np.uint8)


def linear_contrast(img: np.ndarray, factor, rng) -> np.ndarray:
    f = rng.uniform(*factor)
    return np.clip((img.astype(np.float32) - 127.5) * f + 127.5,
                   0, 255).astype(np.uint8)


def partial_grayscale(img: np.ndarray, alpha: float) -> np.ndarray:
    gray = img.astype(np.float32).mean(axis=2, keepdims=True)
    return np.clip((1 - alpha) * img + alpha * gray, 0, 255).astype(np.uint8)


def image_augmenter(img: np.ndarray, rng: np.random.RandomState,
                    prob: float = 0.2) -> np.ndarray:
    """Apply each augmentation with probability `prob` (reference
    dataset_base.py:813-829 uses the same op set + probabilities)."""
    if rng.rand() < prob:
        img = gaussian_blur(img, rng.uniform(0, 1.0))
    if rng.rand() < prob:
        img = additive_gaussian_noise(img, rng.uniform(0, 0.05 * 255), rng,
                                      rng.rand() < 0.5)
    if rng.rand() < prob:
        img = coarse_dropout(img, rng.uniform(0.01, 0.1), rng)
    if rng.rand() < prob:
        img = multiply(img, (1 / 1.2, 1.2), rng, rng.rand() < 0.5)
    if rng.rand() < prob:
        img = linear_contrast(img, (1 / 1.2, 1.2), rng)
    if rng.rand() < prob:
        img = partial_grayscale(img, rng.uniform(0.0, 0.5))
    return img


def clahe_enhance(img: np.ndarray, clip_limit: float = 2.0,
                  tile: int = 8) -> np.ndarray:
    """CLAHE on the L channel (base stack image_enhancing.py:28-56)."""
    import cv2
    lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    clahe = cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=(tile, tile))
    lab[:, :, 0] = clahe.apply(lab[:, :, 0])
    return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)

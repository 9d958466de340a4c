"""Image preprocessing: hood crop -> cubic resize -> normalize -> tiles.

Counterpart of `simlingo_tpu/data/image_pipe.py`: `bottom_crop` (:28) and
`preprocess_numpy` (:64), the CPU tile path (cv2 bicubic) that a dataset
takes with `device_preprocess=False`, and `preprocess_device` (:104-127),
the default, which takes raw uint8 frames on the device. The resize reproduces `jax.image.resize(..., "cubic")`: Keys
cubic with a = -0.5, half-pixel centres, and -- on a downscale, such as the
production frame's 1024 -> 896 width -- an antialiasing kernel widened by
the scale factor, with weights normalized per output pixel. It runs as two
small matrix products with weight matrices built once per size on the host.
(torch's bicubic interpolate is a = -0.75 without antialias, a different
function.)
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def bottom_crop(img: np.ndarray) -> np.ndarray:
    """Remove the bottom 4.8/16 of the frame (the hood)."""
    h = img.shape[0]
    return img[: int(h - (h * 4.8) // 16)]


def find_closest_aspect_ratio(aspect_ratio: float, target_ratios, width: int,
                              height: int, image_size: int) -> Tuple[int, int]:
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        diff = abs(aspect_ratio - ratio[0] / ratio[1])
        if diff < best_diff:
            best_diff, best = diff, ratio
        elif diff == best_diff and area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
            best = ratio
    return best


def select_grid(width: int, height: int, image_size: int = 448,
                min_num: int = 1, max_num: int = 2) -> Tuple[int, int]:
    ratios = sorted({(i, j) for n in range(min_num, max_num + 1)
                     for i, j in itertools.product(range(1, n + 1), repeat=2)
                     if min_num <= i * j <= max_num},
                    key=lambda x: x[0] * x[1])
    return find_closest_aspect_ratio(width / height, ratios, width, height,
                                     image_size)


def preprocess_numpy(img: np.ndarray, image_size: int = 448,
                     max_num: int = 2, use_thumbnail: bool = False,
                     do_bottom_crop: bool = True) -> np.ndarray:
    """uint8 HWC RGB frame -> [NP, image_size, image_size, 3] float32 tiles
    (NP = 2 for the 1024 x 512 camera after the hood crop)."""
    import cv2

    if do_bottom_crop:
        img = bottom_crop(img)
    h, w = img.shape[:2]
    gw, gh = select_grid(w, h, image_size, max_num=max_num)
    resized = cv2.resize(img, (image_size * gw, image_size * gh),
                         interpolation=cv2.INTER_CUBIC)
    tiles = [resized[(i // gw) * image_size:(i // gw + 1) * image_size,
                     (i % gw) * image_size:(i % gw + 1) * image_size]
             for i in range(gw * gh)]
    if use_thumbnail and len(tiles) > 1:
        tiles.append(cv2.resize(img, (image_size, image_size),
                                interpolation=cv2.INTER_CUBIC))
    out = np.stack(tiles).astype(np.float32) / 255.0
    return (out - IMAGENET_MEAN) / IMAGENET_STD


def device_grid_for(width: int, height: int, image_size: int = 448,
                    max_num: int = 2, do_bottom_crop: bool = True
                    ) -> Tuple[int, int]:
    """(gw, gh) tile grid for a raw frame size, after the hood crop."""
    if do_bottom_crop:
        height = int(height - (height * 4.8) // 16)
    return select_grid(width, height, image_size, max_num=max_num)


@functools.lru_cache(maxsize=16)
def _cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] resampling matrix of jax.image.resize(method="cubic")
    (jax/_src/image/scale.py compute_weight_mat), in float32."""
    scale = np.float32(out_size / in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))            # antialias
    sample_f = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


_device_weights: Dict[tuple, torch.Tensor] = {}


def _weights_on(in_size: int, out_size: int, device) -> torch.Tensor:
    key = (in_size, out_size, str(device))
    if key not in _device_weights:
        _device_weights[key] = torch.from_numpy(
            _cubic_weights(in_size, out_size)).to(device)
    return _device_weights[key]


def preprocess_device(frames: torch.Tensor, image_size: int = 448,
                      grid: Tuple[int, int] = (2, 1),
                      do_bottom_crop: bool = True) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, NP, S, S, 3] float32 normalized tiles."""
    B, H, W, C = frames.shape
    if do_bottom_crop:
        H = int(H - (H * 4.8) // 16)
        frames = frames[:, :H]
    gw, gh = grid
    x = frames.float() / 255.0
    wh = _weights_on(H, image_size * gh, x.device)              # [H, H']
    ww = _weights_on(W, image_size * gw, x.device)              # [W, W']
    x = torch.einsum("bhwc,hk->bkwc", x, wh)
    x = torch.einsum("bkwc,wl->bklc", x, ww)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    x = (x - mean) / std
    x = x.reshape(B, gh, image_size, gw, image_size, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, image_size, image_size, C)

"""Synthetic DrivingExample batches for tests, smoke runs and benchmarks.

Counterpart of `simlingo_tpu/data/synthetic.py:synthetic_example` (:20-73):
a chat sequence with an `<IMG_CONTEXT>` block, two waypoint placeholders,
an assistant-only loss mask and driving labels, at the production layout.
The arrays are drawn with numpy from the same `RandomState` sequence as
the JAX function, so the same arguments give the same batch.
"""

from __future__ import annotations

import numpy as np
import torch

from simlingo_tpu_torch.core.device import resolve_device
from simlingo_tpu_torch.core.structs import (DrivingExample, DrivingInput,
                                             DrivingLabel, LanguageLabel)


def synthetic_example(cfg, batch: int, seq_len: int, num_patches: int = 2,
                      max_placeholders: int = 8, seed: int = 0,
                      left_pad: bool = False, image_dtype=torch.float32,
                      device="cuda") -> DrivingExample:
    """cfg: a SimLingoConfig (vocab, image size, image-token count)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    V = cfg.llm.vocab_size
    n_img = cfg.vit.tokens_per_patch_image * num_patches
    img_id = cfg.img_context_token_id

    ids = np.zeros((batch, seq_len), np.int64)
    valid = np.zeros((batch, seq_len), bool)
    loss_mask = np.zeros((batch, seq_len), bool)
    ph_slots = np.full((batch, max_placeholders), -1, np.int64)
    ph_coords = rng.randn(batch, max_placeholders, 2).astype(np.float32)

    prefix = 4  # <|im_start|>user\n<img>
    for b in range(batch):
        n_text = rng.randint(16, 40)
        n_valid = prefix + n_img + n_text
        if n_valid > seq_len:
            raise ValueError(f"seq_len {seq_len} < {n_valid} tokens of sample {b}")
        start = seq_len - n_valid if left_pad else 0
        tok = rng.randint(0, min(V, 30000), size=n_valid).astype(np.int64)
        tok[prefix:prefix + n_img] = img_id
        ids[b, start:start + n_valid] = tok
        valid[b, start:start + n_valid] = True
        ans = n_text // 2             # the last half of the text is the answer
        loss_mask[b, start + n_valid - ans:start + n_valid] = True
        for p in range(2):            # two placeholders in the question
            ph_slots[b, p] = start + prefix + n_img + 2 + p

    H = cfg.vit.image_size
    pixels = rng.randn(batch, num_patches, H, H, 3).astype(np.float32)
    speed = rng.rand(batch).astype(np.float32) * 10
    target = rng.randn(batch, 2).astype(np.float32)
    waypoints = np.cumsum(rng.rand(batch, 11, 2), 1).astype(np.float32)
    path = np.cumsum(rng.rand(batch, 20, 2), 1).astype(np.float32)
    waypoints_1d = np.cumsum(rng.rand(batch, 10, 2), 1).astype(np.float32)

    def t(x, dtype=None):
        return torch.from_numpy(x).to(device=dev, dtype=dtype)

    label = LanguageLabel(ids=t(ids), valid=t(valid), loss_mask=t(loss_mask),
                          ph_slots=t(ph_slots), ph_coords=t(ph_coords))
    di = DrivingInput(pixel_values=t(pixels, image_dtype), vehicle_speed=t(speed),
                      target_point=t(target), prompt=label, prompt_inference=label)
    dl = DrivingLabel(waypoints=t(waypoints), path=t(path),
                      waypoints_1d=t(waypoints_1d))
    return DrivingExample(driving_input=di, driving_label=dl)

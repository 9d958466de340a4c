"""Typed IO structures (torch dataclasses).

Counterpart of `simlingo_tpu/core/structs.py` (flax pytrees there). The
layout contract is the same: static shapes, explicit validity masks,
placeholder splicing as a flat (slot, coord) list padded to a fixed count.
Only the inference structures are ported in this slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class LanguageLabel:
    ids: torch.Tensor          # [B, T] int64 token ids (pad id in invalid slots)
    valid: torch.Tensor        # [B, T] bool, True => token is fed to the model
    loss_mask: torch.Tensor    # [B, T] bool, True => token takes part in the CE loss
    ph_slots: torch.Tensor     # [B, P] int64 sequence index, -1 => unused entry
    ph_coords: torch.Tensor    # [B, P, 2] float32 coordinate for each slot

    @property
    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)

    def to(self, device) -> "LanguageLabel":
        return LanguageLabel(*(getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)))


@dataclasses.dataclass
class DrivingInput:
    # [B, NP, H, W, 3] normalized float tiles, or [B, H, W, 3] uint8 raw
    # frames (preprocessed on the device, data/image_pipe.py)
    pixel_values: torch.Tensor
    vehicle_speed: torch.Tensor         # [B] float32 m/s
    target_point: torch.Tensor          # [B, 2] float32
    prompt: LanguageLabel
    prompt_inference: Optional[LanguageLabel] = None


@dataclasses.dataclass
class DrivingOutput:
    speed_wps: torch.Tensor             # [B, 10, 2]
    route: torch.Tensor                 # [B, 20, 2]
    language_tokens: torch.Tensor       # [B, max_new_tokens] int64
    language_lengths: torch.Tensor      # [B] int64 number of generated tokens

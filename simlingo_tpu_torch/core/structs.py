"""Typed IO structures (torch dataclasses).

Counterpart of `simlingo_tpu/core/structs.py` (flax pytrees there). The
layout contract is the same: static shapes, explicit validity masks,
placeholder splicing as a flat (slot, coord) list padded to a fixed count.
DrivingExample carries no static metadata (run ids, QA templates, eval
infos): the training step does not read it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

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


@dataclasses.dataclass
class DrivingLabel:
    waypoints: torch.Tensor     # [B, 11, 2] future positions, 0.25 s apart
    path: torch.Tensor          # [B, 20, 2] route points, 1 m spacing
    waypoints_1d: torch.Tensor  # [B, 10, 2] cumulative-distance waypoints ([d, 0])


@dataclasses.dataclass
class DrivingExample:
    """One training batch."""
    driving_input: DrivingInput
    driving_label: DrivingLabel


@dataclasses.dataclass
class TrainingOutput:
    loss: torch.Tensor                      # [] float32
    loss_averages: Dict[str, torch.Tensor]  # {} -> [] float32
    loss_counts: Dict[str, torch.Tensor]    # {} -> [] int32


def summarise_losses(loss_values: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                     count_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                     ) -> TrainingOutput:
    """{key: (values, count mask)} -> TrainingOutput: each key's average is
    sum(values * mask) / max(sum(mask), 1); the total loss is the
    unweighted sum of the per-key averages.

    `count_reduce` takes this batch's counts (a float32 vector in key order)
    to the global batch's: a rank of a multi-GPU step holds part of the
    batch, and its averages are its share of the global averages (their
    sum over the ranks), so a step over dp ranks equals the one-process
    step whatever rows each rank holds. The counts returned are the
    global ones."""
    masks = {k: m.to(v.dtype) for k, (v, m) in loss_values.items()}
    ns = {k: m.sum() for k, m in masks.items()}
    if count_reduce is not None and ns:
        total = count_reduce(torch.stack([n.detach().float() for n in ns.values()]))
        ns = {k: t.to(ns[k].dtype) for k, t in zip(ns, total.unbind())}
    averages, counts = {}, {}
    for key, (values, _) in loss_values.items():
        n = ns[key]
        averages[key] = (values * masks[key]).sum() / torch.clamp(n, min=1.0)
        counts[key] = n.to(torch.int32)
    loss = sum(averages.values()) if averages else torch.zeros(())
    return TrainingOutput(loss=loss, loss_averages=averages, loss_counts=counts)

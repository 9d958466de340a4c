"""Collate: RawSamples -> one static-shape DrivingExample, then to the device.

Counterpart of `simlingo_tpu/data/collate.py` (`CollateConfig` :24,
`collate` :34): text padded to a fixed max_text_len, waypoints and route
cut or padded to fixed counts, raw uint8 frames (or float tiles) stacked.
The batch is built as CPU tensors; `to_device` packs all of them into one
pinned buffer and moves it with one non-blocking host-to-device copy. The
static metadata of the JAX batch (run ids, QA templates, eval infos) is
not carried: the training step does not read it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from simlingo_tpu_torch.core.structs import (DrivingExample, DrivingInput,
                                             DrivingLabel, LanguageLabel)
from simlingo_tpu_torch.data.driving_dataset import RawSample
from simlingo_tpu_torch.data.prompts import batch_language_label, tokenize_chat
from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer


@dataclasses.dataclass
class CollateConfig:
    max_text_len: int = 768       # >= prefix(4) + img tokens + prompt + answer
    num_image_tokens: int = 512   # 2 tiles x 256 tokens (InternVL2-1B)
    max_placeholders: int = 8
    num_speed_wps: int = 10
    num_route_points: int = 20
    pad_side_train: str = "right"
    pad_side_infer: str = "left"


def _fixlen(x, n: int) -> np.ndarray:
    """First n rows of [N, 2], the last row repeated where N < n."""
    x = np.asarray(x, np.float32)
    if len(x) >= n:
        return x[:n]
    return np.vstack([x, np.tile(x[-1:], (n - len(x), 1))])


def collate(samples: Sequence[RawSample], tok: SimLingoTokenizer,
            cfg: CollateConfig) -> DrivingExample:
    """One batch of CPU tensors (the training layout: right-padded prompt,
    left-padded question-only prompt for inference)."""
    chats = [tokenize_chat(tok, s.question, s.answer, cfg.num_image_tokens)
             for s in samples]
    chats_q = [tokenize_chat(tok, s.question, None, cfg.num_image_tokens)
               for s in samples]
    placeholder_values = [{tok.convert_tokens_to_ids(k): v
                           for k, v in s.placeholder_values.items()} for s in samples]
    prompt = batch_language_label(chats, placeholder_values, tok.pad_token_id,
                                  cfg.max_text_len, pad_side=cfg.pad_side_train,
                                  max_placeholders=cfg.max_placeholders)
    prompt_inference = batch_language_label(
        chats_q, placeholder_values, tok.pad_token_id, cfg.max_text_len,
        pad_side=cfg.pad_side_infer, max_placeholders=cfg.max_placeholders)

    images = np.stack([s.image for s in samples])
    if images.dtype != np.uint8:             # raw frames stay uint8
        images = images.astype(np.float32)

    def stack(rows) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(np.stack(rows), np.float32))

    di = DrivingInput(
        pixel_values=torch.from_numpy(images),
        vehicle_speed=stack([s.speed for s in samples]),
        target_point=stack([s.target_points[0] for s in samples]),
        prompt=prompt, prompt_inference=prompt_inference)
    dl = DrivingLabel(
        waypoints=stack([_fixlen(s.waypoints, cfg.num_speed_wps) for s in samples]),
        path=stack([_fixlen(s.path, cfg.num_route_points) for s in samples]),
        waypoints_1d=stack([_fixlen(s.waypoints_1d, cfg.num_speed_wps)
                            for s in samples]))
    return DrivingExample(driving_input=di, driving_label=dl)


_LABEL_FIELDS = [f.name for f in dataclasses.fields(LanguageLabel)]


def _tensors(ex: DrivingExample) -> List[torch.Tensor]:
    di, dl = ex.driving_input, ex.driving_label
    out = [di.pixel_values, di.vehicle_speed, di.target_point]
    for label in (di.prompt, di.prompt_inference):
        out += [getattr(label, f) for f in _LABEL_FIELDS]
    return out + [dl.waypoints, dl.path, dl.waypoints_1d]


def _rebuild(ts: List[torch.Tensor]) -> DrivingExample:
    n = len(_LABEL_FIELDS)
    prompt = LanguageLabel(*ts[3:3 + n])
    prompt_inference = LanguageLabel(*ts[3 + n:3 + 2 * n])
    di = DrivingInput(pixel_values=ts[0], vehicle_speed=ts[1], target_point=ts[2],
                      prompt=prompt, prompt_inference=prompt_inference)
    return DrivingExample(driving_input=di,
                          driving_label=DrivingLabel(*ts[3 + 2 * n:]))


def pack(ex: DrivingExample, pin: bool = False
         ) -> Tuple[torch.Tensor, List[Tuple[int, torch.dtype, torch.Size]]]:
    """All tensors of the batch in one uint8 host buffer, each at a 16-byte
    aligned offset; returns the buffer and each tensor's (offset, dtype,
    shape)."""
    ts = _tensors(ex)
    specs, total = [], 0
    for t in ts:
        specs.append((total, t.dtype, t.shape))
        total += (t.numel() * t.element_size() + 15) // 16 * 16
    host = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    for t, (off, _, _) in zip(ts, specs):
        flat = t.contiguous().reshape(-1).view(torch.uint8)
        host[off:off + flat.numel()].copy_(flat)
    return host, specs


def unpack(buf: torch.Tensor, specs) -> DrivingExample:
    """The batch as views of `buf` (a packed buffer, on any device)."""
    views = []
    for off, dtype, shape in specs:
        n = shape.numel() * torch.empty((), dtype=dtype).element_size()
        views.append(buf[off:off + n].view(dtype).view(shape))
    return _rebuild(views)


def to_device(ex: DrivingExample, device, stream=None
              ) -> Tuple[DrivingExample, Optional[torch.Tensor]]:
    """The batch on `device`. On a CUDA device it is packed into one pinned
    host buffer and moved by one non-blocking copy, issued on `stream` if
    given; the batch's tensors are views of the one device buffer, which
    is returned beside it (the consumer calls `record_stream` on it). On
    the CPU the batch is returned as it is, with None."""
    device = torch.device(device)
    if device.type != "cuda":
        return ex, None
    host, specs = pack(ex, pin=True)
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        buf = host.to(device, non_blocking=True)
    return unpack(buf, specs), buf

"""Bridge from the JAX package's parameters and batches to the port's.

No JAX counterpart. Takes the JAX trees as nested dicts of array-likes
(numpy arrays, or anything `np.asarray` accepts) and never imports JAX.

Layout rule: JAX linears are stored [in, out] (`simlingo_tpu/models/
layers.py:46-53`); the port stores torch's [out, in]. So every 2-D "w" /
"w_q" of a linear is transposed -- int8 weights become [N, K] row-major,
the one layout of every int8 product -- while embedding tables ("embed",
[V, H]) keep their layout and their per-row scales. LoRA factors become the
peft layout: a [in, r] -> [r, in], b [r, out] -> [out, r].
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from simlingo_tpu_torch.core.device import resolve_device
from simlingo_tpu_torch.core.structs import (DrivingExample, DrivingInput,
                                             DrivingLabel, LanguageLabel)


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":     # numpy has no bf16: exact via fp32
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(node, key: str, device):
    if not isinstance(node, dict):
        return _tensor(node, device)
    out = {}
    is_linear = key != "embed" and ("w" in node or "w_q" in node)
    is_lora = set(node) == {"a", "b"}
    for k, v in node.items():
        if isinstance(v, dict):
            out[k] = _convert(v, k, device)
            continue
        t = _tensor(v, device)
        if (is_linear and k in ("w", "w_q") and t.dim() == 2) or is_lora:
            t = t.t().contiguous()
        out[k] = t
    return out


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """JAX parameter tree -> the port's tree; every leaf keeps its dtype."""
    return _convert(tree, "", resolve_device(device))


def label_from_jax(label, device="cuda") -> LanguageLabel:
    """A JAX/numpy LanguageLabel (any object with the five fields)."""
    dev = resolve_device(device)
    return LanguageLabel(
        ids=_tensor(label.ids, dev).long(), valid=_tensor(label.valid, dev).bool(),
        loss_mask=_tensor(label.loss_mask, dev).bool(),
        ph_slots=_tensor(label.ph_slots, dev).long(),
        ph_coords=_tensor(label.ph_coords, dev).float())


def input_from_jax(di, device="cuda") -> DrivingInput:
    dev = resolve_device(device)
    prompt = label_from_jax(di.prompt, dev)
    pi = di.prompt_inference
    return DrivingInput(
        pixel_values=_tensor(di.pixel_values, dev),
        vehicle_speed=_tensor(di.vehicle_speed, dev),
        target_point=_tensor(di.target_point, dev),
        prompt=prompt,
        prompt_inference=None if pi is None else label_from_jax(pi, dev))


def example_from_jax(ex, device="cuda") -> DrivingExample:
    """A JAX DrivingExample (its static metadata is dropped)."""
    dev = resolve_device(device)
    dl = ex.driving_label
    return DrivingExample(
        driving_input=input_from_jax(ex.driving_input, dev),
        driving_label=DrivingLabel(waypoints=_tensor(dl.waypoints, dev),
                                   path=_tensor(dl.path, dev),
                                   waypoints_1d=_tensor(dl.waypoints_1d, dev)))

"""Device resolution for the port's entry points (no JAX counterpart).

Entry points default to the GPU. A caller that wants the CPU (the parity
tests) says so with ``device="cpu"``; asking for CUDA on a machine without
a GPU raises instead of falling back.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "simlingo_tpu_torch: device='cuda' requested but no CUDA GPU is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev

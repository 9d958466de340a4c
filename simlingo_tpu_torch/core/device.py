"""Device resolution for the port's entry points (no JAX counterpart).

Entry points default to the GPU. A caller that wants the CPU (the parity
tests) says so with ``device="cpu"``; asking for CUDA on a machine without
a GPU raises instead of falling back.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def fp32_products(precision: str, device: DeviceLike):
    """At precision "fp32" on the GPU, keep fp32 products fp32 for the run:
    TF32 off for cuBLAS's matmuls and cuDNN's convolutions (cuDNN takes TF32
    by default), the previous settings restored after. JAX's fp32 step
    computes fp32 products on the CPU, and the hand kernels at fp32 use
    fp32 FMAs. Yields whether it turned TF32 off."""
    on = precision == "fp32" and torch.device(device).type == "cuda"
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if on:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield on
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

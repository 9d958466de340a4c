"""w8a16 (int8-weight, bf16-activation) matmul.

Counterpart of `simlingo_tpu/kernels/quantized_matmul.py` (`_kernel` :49,
reached via `_int8_matmul_impl` :302). The port keeps ONE weight layout for
every int8 product: torch's [N, K] (out, in) row-major, so the linears and
the tied [V, H] LM head (the JAX `transpose_rhs=True` case) take the same
kernel. Quantization is symmetric per output channel:

    w_q[n, k] = round(w[n, k] / scale[n]),  scale[n] = max_k |w[n, k]| / 127

On a CUDA tensor `int8_matmul` launches the hand-written kernel
(`csrc/int8_matmul.cu`); on a CPU tensor it runs `int8_matmul_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from simlingo_tpu_torch.kernels import _build


def quantize_weight(w: torch.Tensor, axis: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [N, K] -> (w_q int8 [N, K], scale f32 [N]) (axis=0: per row).

    axis=1 keeps one scale per column instead. Bit-identical to the JAX
    quantize_weight: fp32 division, round half to even, clip to +-127."""
    w = w.float()
    amax = w.abs().amax(dim=1 - axis)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    sc = scale[:, None] if axis == 0 else scale[None, :]
    w_q = torch.clamp(torch.round(w / sc), -127, 127).to(torch.int8)
    return w_q, scale


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 product of x and the int8 codes, scaled per
    output channel, cast back to x's dtype."""
    acc = x.float() @ w_q.float().t()
    return (acc * scale.float()).to(x.dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """y[..., n] = sum_k x[..., k] * w_q[n, k] * scale[n].

    x [..., K] (bf16 on the GPU), w_q int8 [N, K], scale f32 [N]."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale)
    return _int8_matmul_cuda(x, w_q, scale)


def _int8_matmul_cuda(x, w_q, scale):
    N, K = w_q.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int8_matmul kernel takes bf16 activations, got {x.dtype}")
    if w_q.dtype != torch.int8 or not w_q.is_contiguous():
        raise TypeError("int8_matmul kernel takes a contiguous int8 [N, K] weight")
    if scale.dtype != torch.float32 or scale.shape != (N,) or not scale.is_contiguous():
        raise TypeError("int8_matmul kernel takes a contiguous float32 [N] scale")
    if x.shape[-1] != K or K % 16 != 0:
        raise ValueError(f"int8_matmul kernel needs K % 16 == 0 and x[..., K]; "
                         f"got x {tuple(x.shape)}, w_q {tuple(w_q.shape)}")
    if not (x.device == w_q.device == scale.device):
        raise ValueError("int8_matmul: tensors on different devices")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    for t in (x2, w_q):
        if t.data_ptr() % 16:
            raise ValueError("int8_matmul kernel needs 16-byte aligned operands")
    lib = _lib()
    rc = lib.simlingo_int8_matmul(
        x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, N, K, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "int8_matmul")
    int8_matmul.launches += 1
    return out.reshape(*lead, N)


int8_matmul.launches = 0


def _lib():
    lib = _build.load("int8_matmul")
    fn = lib.simlingo_int8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib

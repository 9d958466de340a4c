"""Primitive layers as plain functions over parameter dicts.

Counterpart of `simlingo_tpu/models/layers.py`. Parameter trees keep the
JAX key names, but linear weights are stored torch-style [out, in]
(core/from_jax.py transposes). Weights are cast to the activation's dtype
at apply time; norms compute in fp32 and cast back. With
SIMLINGO_LN_IMPL=pallas (`core/gates.py`) the norms run the fused kernels
of `kernels/layernorm.py`, as `simlingo_tpu/models/layers.py:90-110` does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from simlingo_tpu_torch.core import gates
from simlingo_tpu_torch.kernels import layernorm as fused_norm
from simlingo_tpu_torch.kernels.quantized_matmul import int8_matmul

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers (explicit torch.Generator; the streams differ from JAX's)
# ---------------------------------------------------------------------------

def _normal(gen, shape, std=0.02, dtype=torch.float32, device="cpu"):
    return std * torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _uniform(gen, shape, bound, dtype=torch.float32, device="cpu"):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return (2.0 * u - 1.0) * bound


def linear_init(gen, in_dim: int, out_dim: int, use_bias: bool = True,
                dtype=torch.float32, device="cpu") -> Params:
    """Weight [out_dim, in_dim]; torch.nn.Linear's default U(+-1/sqrt(in))."""
    bound = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform(gen, (out_dim, in_dim), bound, dtype, device)}
    if use_bias:
        p["b"] = _uniform(gen, (out_dim,), bound, dtype, device)
    return p


def layernorm_init(dim: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def rmsnorm_init(dim: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones(dim, dtype=dtype, device=device)}


def mlp_stack_init(gen, dims, use_bias=None, dtype=torch.float32,
                   device="cpu") -> Params:
    n = len(dims) - 1
    use_bias = use_bias or [True] * n
    return {f"l{i}": linear_init(gen, dims[i], dims[i + 1], use_bias[i],
                                 dtype, device) for i in range(n)}


# ---------------------------------------------------------------------------
# Linear / embedding
# ---------------------------------------------------------------------------

def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x W^T + b; an int8 weight {"w_q" [N, K], "scale" [N]} runs the
    w8a16 kernel."""
    if "w_q" in p:
        y = int8_matmul(x, p["w_q"], p["scale"])
        if "b" in p:
            y = y + p["b"].to(y.dtype)
        return y
    b = p["b"].to(x.dtype) if "b" in p else None
    return F.linear(x, p["w"].to(x.dtype), b)


def embed(p: Params, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    if "w_q" in p:      # per-row int8 table: gather rows, dequantize per row
        ids = ids.clamp(0, p["w_q"].shape[0] - 1)
        rows = p["w_q"][ids].to(dtype or torch.float32)
        return rows * p["scale"][ids].to(rows.dtype)[..., None]
    w = p["w"] if dtype is None else p["w"].to(dtype)
    return w[ids.clamp(0, w.shape[0] - 1)]


# ---------------------------------------------------------------------------
# Norms (fp32 internals)
# ---------------------------------------------------------------------------

def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if gates.ln_impl() == "pallas":
        return fused_norm.layernorm_fused(x, p["scale"], p["bias"], eps)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if gates.ln_impl() == "pallas":
        return fused_norm.rmsnorm_fused(x, p["scale"], eps)
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def gelu_mlp(p: Params, x: torch.Tensor, approximate: bool = False
             ) -> torch.Tensor:
    """fc1 -> GELU (erf; tanh form if approximate) -> fc2."""
    h = F.gelu(linear(p["fc1"], x), approximate="tanh" if approximate else "none")
    return linear(p["fc2"], h)


def mlp_stack(p: Params, x: torch.Tensor, act, final_act: bool = False
              ) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = linear(p[f"l{i}"], x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-rotation layout)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 1e6, device="cpu"
                     ) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_cos_sin(position_ids: torch.Tensor, inv_freq: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """position_ids [..., T] -> (cos, sin) each [..., T, head_dim], fp32."""
    angles = position_ids[..., None].float() * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    d2 = x.shape[-1] // 2
    return torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, T, H, D]; cos/sin [B, T, D] (cast to x's dtype)."""
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return x * cos + rotate_half(x) * sin

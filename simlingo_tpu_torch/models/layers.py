"""Primitive layers as plain functions over parameter dicts.

Counterpart of `simlingo_tpu/models/layers.py`. Parameter trees keep the
JAX key names, but linear weights are stored torch-style [out, in]
(core/from_jax.py transposes). Weights are cast to the activation's dtype
at apply time; norms compute in fp32 and cast back. With
SIMLINGO_LN_IMPL=pallas (`core/gates.py`) the norms run the fused kernels
of `kernels/layernorm.py`, as `simlingo_tpu/models/layers.py:90-110` does.

Tensor parallelism (`parallel/mesh.py`; no JAX counterpart, where XLA
partitions the same products): `tp` is the tp group's `Comm`, or None to
run unsplit. A column-parallel linear takes a replicated input, passed
once through `tp_copy` (identity forward, gradient all-reduced over tp),
and gives this rank's output features; a row-parallel linear takes this
rank's input features, all-reduces its partial output (`tp_reduce`) and
then adds the bias. `tp_params` cuts what is stored replicated to the
rank's slice: a quantized weight (JAX's rules keep it unsplit) and a
column-parallel bias that is not stored split.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from simlingo_tpu_torch.core import gates
from simlingo_tpu_torch.kernels import layernorm as fused_norm
from simlingo_tpu_torch.kernels.quantized_matmul import (int4_matmul, int8_matmul,
                                                         unpack_int4)

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


def gelu_mlp_init(gen, dim: int, hidden: int, dtype=torch.float32,
                  device="cpu") -> Params:
    """fc1 [hidden, dim] and fc2 [dim, hidden], each with a bias."""
    return {"fc1": linear_init(gen, dim, hidden, True, dtype, device),
            "fc2": linear_init(gen, hidden, dim, True, dtype, device)}


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
    """y = x W^T + b. A quantized weight is told by its scale's rank, as
    JAX's (`layers.py:56-61`): int8 {"w_q" [N, K], "scale" [N]} runs the
    w8a16 kernel, int4 {"w_q" [N, K // 2], "scale" [N, G]} the w4a16
    product."""
    if "w_q" in p:
        qmm = int4_matmul if p["scale"].dim() == 2 else int8_matmul
        y = qmm(x, p["w_q"], p["scale"])
        if "b" in p:
            y = y + p["b"].to(y.dtype)
        return y
    b = p["b"].to(x.dtype) if "b" in p else None
    return F.linear(x, p["w"].to(x.dtype), b)


def embed(p: Params, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    if "w_q" in p:      # quantized table: gather rows, dequantize each
        ids = ids.clamp(0, p["w_q"].shape[0] - 1)
        rows, sc = p["w_q"][ids], p["scale"][ids]
        if sc.dim() == rows.dim():       # int4: packed rows, group scales [.., G]
            rows = unpack_int4(rows, dim=-1).to(dtype or torch.float32)
            H, G = rows.shape[-1], sc.shape[-1]
            rows = rows.reshape(*rows.shape[:-1], G, H // G) * sc.to(rows.dtype)[..., None]
            return rows.reshape(*rows.shape[:-2], H)
        rows = rows.to(dtype or torch.float32)
        return rows * sc.to(rows.dtype)[..., None]
    w = p["w"] if dtype is None else p["w"].to(dtype)
    return w[ids.clamp(0, w.shape[0] - 1)]


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.contiguous().clone()), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_copy(x: torch.Tensor, tp) -> torch.Tensor:
    """The replicated input of column-parallel linears."""
    return x if tp is None else _CopyToTP.apply(x, tp)


def tp_reduce(x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel partial output summed over tp."""
    return x if tp is None else _ReduceFromTP.apply(x, tp)


def tp_slice(x: torch.Tensor, dim: int, tp) -> torch.Tensor:
    """This tp rank's 1/tp of `dim` (a view)."""
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * n, n)


def tp_params(p: Params, role: str, tp) -> Params:
    """A linear's parameters as this tp rank uses them: role "column"
    (output features split) or "row" (input features split; the bias is
    left out, `row_linear` adds it after the reduction)."""
    if tp is None:
        return p
    q = dict(p)
    if "w_q" in p:                       # stored replicated
        if role == "column":
            q["w_q"], q["scale"] = tp_slice(p["w_q"], 0, tp), tp_slice(p["scale"], 0, tp)
        elif p["scale"].dim() == 2:
            raise ValueError("an int4 weight does not split over tp along its input")
        else:
            q["w_q"] = tp_slice(p["w_q"], 1, tp).contiguous()
        n_out = q["w_q"].shape[0]
    else:
        n_out = p["w"].shape[0]
    if role == "row":
        q.pop("b", None)
    elif "b" in p and p["b"].shape[0] != n_out:
        q["b"] = tp_slice(p["b"], 0, tp)
    return q


def column_linear(p: Params, x: torch.Tensor, tp) -> torch.Tensor:
    """x (replicated, through `tp_copy`) -> this rank's output features."""
    return linear(tp_params(p, "column", tp), x)


def row_finish(y: torch.Tensor, p: Params, tp) -> torch.Tensor:
    """A row-parallel linear's partial output -> the whole output: summed
    over tp, then the bias of `p`."""
    y = tp_reduce(y, tp)
    return y + p["b"].to(y.dtype) if "b" in p else y


def row_linear(p: Params, x: torch.Tensor, tp) -> torch.Tensor:
    """x (this rank's input features) -> the whole output."""
    if tp is None:
        return linear(p, x)
    return row_finish(linear(tp_params(p, "row", tp), x), p, tp)


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

def gelu_mlp(p: Params, x: torch.Tensor, approximate: bool = False,
             recompute_gelu: bool = False, tp=None) -> torch.Tensor:
    """fc1 -> GELU (erf; tanh form if approximate) -> fc2; under `tp` fc1
    column-parallel and fc2 row-parallel.

    `recompute_gelu` (the ViT's remat="mlp") keeps the pre-GELU hidden for
    the backward but not the GELU's output, which the backward recomputes
    from it for fc2's weight gradient: JAX's
    `save_anything_except_these_names("mlp_gelu_out")`
    (`simlingo_tpu/models/layers.py:132-145`). Neither product re-runs."""
    h = column_linear(p["fc1"], tp_copy(x, tp), tp)
    approx = "tanh" if approximate else "none"
    fc2 = tp_params(p["fc2"], "row", tp)
    if recompute_gelu and torch.is_grad_enabled():
        b = fc2.get("b")
        y = _GeluLinear.apply(h, fc2["w"].to(h.dtype), None if b is None else b.to(h.dtype),
                              approx)
    else:
        y = linear(fc2, F.gelu(h, approximate=approx))
    return y if tp is None else row_finish(y, p["fc2"], tp)


class _GeluLinear(torch.autograd.Function):
    """F.linear(F.gelu(h), w, b), saving h (not the GELU's output) and w."""

    @staticmethod
    def forward(ctx, h, w, b, approximate: str):
        ctx.save_for_backward(h, w)
        ctx.approximate = approximate
        return F.linear(F.gelu(h, approximate=approximate), w, b)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        with torch.enable_grad():
            hh = h.detach().requires_grad_(True)
            act = F.gelu(hh, approximate=ctx.approximate)      # recomputed
        need_h, need_w, need_b = ctx.needs_input_grad[:3]
        g2 = g.reshape(-1, g.shape[-1])
        dw = g2.t() @ act.detach().reshape(-1, act.shape[-1]) if need_w else None
        db = g2.sum(0) if need_b else None
        dh = torch.autograd.grad(act, hh, g @ w)[0] if need_h else None
        return dh, dw, db, None


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

"""Flash attention with slot-order causality and key validity.

Counterpart of `simlingo_tpu/kernels/flash_attention.py`. Forward: one CUDA
kernel (`csrc/flash_attn_fwd.cu`) covers the three Pallas forward kernels
-- `_fwd_kernel_gqa` (:308, the LLM), `_fwd_kernel_pair` (:786, the ViT
read from the flat projection output) and `_fwd_kernel` (:114, plain MHA).
Backward (training): `csrc/flash_attn_bwd.cu` covers `_bwd_kernel_gqa`
(:382), `_bwd_kernel_pair` (:869) and `_bwd_kernel` (:205) the same way,
from the output and the forward's base-2 log-sum-exp (`attention_train`).

Semantics (as `attention_reference` in the JAX package, :71-107):
  * q [B, T, HQ, D], k/v [B, S, HK, D]; query head h reads kv head
    h // (HQ // HK) (heads are kv-major);
  * causal masking is slot-order: query row i sits at slot i + q_offset and
    sees key slots <= that; q_offset None means S - T;
  * kv_valid [B, S] bool masks keys; a row with no visible valid key
    returns 0.

On a CUDA tensor `attention` launches the kernel (bf16, D = 64); on a CPU
tensor it runs `attention_reference`. `attention_train` does the same for
the forward and, in its backward, launches `flash_attn_bwd` on CUDA tensors
and runs `attention_bwd_reference` on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from simlingo_tpu_torch.kernels import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_valid: Optional[torch.Tensor], causal: bool,
                        scale: Optional[float] = None,
                        q_offset: Optional[int] = None) -> torch.Tensor:
    """Plain version in fp32: masked softmax(scale * q k^T) v."""
    B, T, HQ, D = q.shape
    _, S, HK, _ = k.shape
    group = HQ // HK
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = S - T
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", qf, kf)
    mask = torch.ones((B, 1, T, S), dtype=torch.bool, device=q.device)
    if causal:
        q_slot = torch.arange(T, device=q.device)[:, None] + q_offset
        kv_slot = torch.arange(S, device=q.device)[None, :]
        mask = mask & (kv_slot <= q_slot)[None, None]
    if kv_valid is not None:
        mask = mask & kv_valid.bool()[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.clamp(l, min=1e-30)
    out = torch.einsum("bhts,bshd->bthd", p, vf)
    any_valid = mask.any(dim=-1)                          # [B, H|1, T]
    out = out * any_valid.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_valid: Optional[torch.Tensor] = None, causal: bool = True,
              scale: Optional[float] = None,
              q_offset: Optional[int] = None) -> torch.Tensor:
    """[B, T, HQ, D] x [B, S, HK, D] -> [B, T, HQ, D]."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_valid, causal, scale, q_offset)
    return flash_attn_fwd(q, k, v, kv_valid, causal, scale, q_offset)


def _check_bthd(name, x, D):
    if x.dim() != 4 or x.shape[-1] != D or x.stride(-1) != 1:
        raise ValueError(f"flash_attn_fwd: {name} must be [B, L, H, {D}] with "
                         f"unit stride in D, got {tuple(x.shape)} / {x.stride()}")


def flash_attn_fwd(q, k, v, kv_valid=None, causal=True, scale=None,
                   q_offset=None, return_lse=False):
    """Launch the CUDA kernel. q/k/v may be strided views (e.g. heads of a
    [B, T, H*D] projection, or a KV cache); no copy is made. With
    `return_lse` also returns the base-2 log-sum-exp [B, HQ, T] fp32 of
    the scaled logits (-inf where a row sees no valid key)."""
    B, T, HQ, D = q.shape
    _, S, HK, _ = k.shape
    if D != 64:
        raise ValueError(f"flash_attn_fwd kernel needs head_dim 64, got {D}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_attn_fwd kernel takes bf16, {name} is {x.dtype}")
        _check_bthd(name, x, D)
    if k.shape != v.shape or k.shape[0] != B or HQ % HK:
        raise ValueError(f"flash_attn_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    # k/v tiles are read 16 bytes at a time
    for name, x in (("k", k), ("v", v)):
        if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
            raise ValueError(f"flash_attn_fwd: {name} rows must be 16-byte aligned")
    if q.data_ptr() % 4 or any(s % 2 for s in q.stride()[:3]):
        raise ValueError("flash_attn_fwd: q rows must be 4-byte aligned")
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = S - T
    valid_ptr = None
    if kv_valid is not None:
        kv_valid = kv_valid.to(device=q.device, dtype=torch.uint8)
        kv_valid = kv_valid.expand(B, S).contiguous()
        valid_ptr = kv_valid.data_ptr()
    out = torch.empty((B, T, HQ, D), dtype=torch.bfloat16, device=q.device)
    lse = (torch.empty((B, HQ, T), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B * T == 0:
        return (out, lse) if return_lse else out
    lib = _lib()
    rc = lib.simlingo_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr, out.data_ptr(),
        lse.data_ptr() if return_lse else None, B, T, S, HQ, HK,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), int(q_offset), ctypes.c_float(float(scale)),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attn_fwd")
    flash_attn_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attn_fwd.launches = 0


def _lib():
    lib = _build.load("flash_attn_fwd")
    fn = lib.simlingo_flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Training: lse, the backward, and the autograd Function
# ---------------------------------------------------------------------------

def _scaled_logits(q, k, kv_valid, causal, scale, q_offset):
    """fp32 scale * q k^T [B, HQ, T, S] and the visibility mask."""
    B, T, HQ, D = q.shape
    _, S, HK, _ = k.shape
    kf = k.float().repeat_interleave(HQ // HK, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q.float() * scale, kf)
    mask = torch.ones((B, 1, T, S), dtype=torch.bool, device=q.device)
    if causal:
        q_slot = torch.arange(T, device=q.device)[:, None] + q_offset
        mask = mask & (torch.arange(S, device=q.device)[None, :] <= q_slot)
    if kv_valid is not None:
        mask = mask & kv_valid.bool()[:, None, None, :]
    return logits, mask


def _defaults(q, k, scale, q_offset):
    return (q.shape[-1] ** -0.5 if scale is None else scale,
            k.shape[1] - q.shape[1] if q_offset is None else q_offset)


def attention_lse_reference(q, k, kv_valid, causal, scale=None, q_offset=None):
    """Plain version of the forward's lse: base-2 log-sum-exp [B, HQ, T]
    fp32 over the visible keys of each row, -inf where there are none."""
    scale, q_offset = _defaults(q, k, scale, q_offset)
    logits, mask = _scaled_logits(q, k, kv_valid, causal, scale, q_offset)
    logits = logits.masked_fill(~mask, float("-inf"))
    return torch.logsumexp(logits, dim=-1) * LOG2E


def attention_bwd_reference(q, k, v, kv_valid, o, dout, lse, causal,
                            scale=None, q_offset=None, abs_terms=False):
    """Plain version of `flash_attn_bwd`, the kernel's algorithm in fp32:
    P = exp2(s * log2(e) - lse) on visible pairs, delta = rowsum(dO * O),
    dS = P (dO V^T - delta); returns (dq, dk, dv) fp32 with dk/dv summed
    over each kv head's query-head group. Rows with lse = -inf give 0.
    With `abs_terms`, returns instead the sum of |term| of each gradient
    element (|dS| |K|, |dS| |Q|, P |dO|): the kernel rounds dS and P to
    bf16 before these products, so its error is within 2^-8 of that sum
    (plus the rounding of its bf16 output)."""
    B, T, HQ, D = q.shape
    _, S, HK, _ = k.shape
    group = HQ // HK
    scale, q_offset = _defaults(q, k, scale, q_offset)
    logits, mask = _scaled_logits(q, k, kv_valid, causal, scale, q_offset)
    lse = torch.where(lse == float("-inf"), float("inf"), lse.float())
    p = torch.where(mask, torch.exp2(logits * LOG2E - lse[..., None]),
                    torch.zeros((), device=q.device))
    do = dout.float()
    vf = v.float().repeat_interleave(group, dim=2)
    kf = k.float().repeat_interleave(group, dim=2)
    delta = (do * o.float()).sum(-1).transpose(1, 2)            # [B, HQ, T]
    ds = p * (torch.einsum("bthd,bshd->bhts", do, vf) - delta[..., None])
    if abs_terms:
        ds, kf, q, do = ds.abs(), kf.abs(), q.abs(), do.abs()
    dq = scale * torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = scale * torch.einsum("bhts,bthd->bshd", ds, q.float())
    dv = torch.einsum("bhts,bthd->bshd", p, do)
    return (dq, dk.view(B, S, HK, group, D).sum(3),
            dv.view(B, S, HK, group, D).sum(3))


def _aligned16(name, x):
    if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
        raise ValueError(f"flash_attn_bwd: {name} rows must be 16-byte aligned")


def flash_attn_bwd(q, k, v, kv_valid, o, dout, lse, causal=True, scale=None,
                   q_offset=None):
    """Launch the CUDA backward: (dq [B,T,HQ,D], dk, dv [B,S,HK,D]) bf16.
    q/k/v may be strided views as in the forward; o and dout are made
    contiguous; lse is the forward's [B, HQ, T] fp32."""
    B, T, HQ, D = q.shape
    _, S, HK, _ = k.shape
    if D != 64:
        raise ValueError(f"flash_attn_bwd kernel needs head_dim 64, got {D}")
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o), ("dout", dout)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_attn_bwd kernel takes bf16, {name} is {x.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_bthd(name, x, D)
        _aligned16(name, x)
    if k.shape != v.shape or k.shape[0] != B or HQ % HK or o.shape != q.shape \
            or dout.shape != q.shape or lse.shape != (B, HQ, T):
        raise ValueError(f"flash_attn_bwd: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, o {tuple(o.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)}")
    if lse.dtype != torch.float32:
        raise TypeError(f"flash_attn_bwd takes an fp32 lse, got {lse.dtype}")
    scale, q_offset = _defaults(q, k, scale, q_offset)
    o, dout, lse = o.contiguous(), dout.contiguous(), lse.contiguous()
    valid_ptr = None
    if kv_valid is not None:
        kv_valid = kv_valid.to(device=q.device, dtype=torch.uint8)
        kv_valid = kv_valid.expand(B, S).contiguous()
        valid_ptr = kv_valid.data_ptr()
    dq = torch.empty((B, T, HQ, D), dtype=torch.bfloat16, device=q.device)
    dk = torch.empty((B, S, HK, D), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty((B, S, HK, D), dtype=torch.bfloat16, device=q.device)
    if B * T * S == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, HQ, T), dtype=torch.float32, device=q.device)
    rc = _bwd_lib().simlingo_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr, o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, S, HQ, HK,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), int(q_offset), ctypes.c_float(float(scale)),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attn_bwd")
    flash_attn_bwd.launches += 1
    return dq, dk, dv


flash_attn_bwd.launches = 0


def _bwd_lib():
    lib = _build.load("flash_attn_bwd")
    fn = lib.simlingo_flash_attn_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


class _AttentionTrain(torch.autograd.Function):
    """Flash attention whose forward saves (q, k, v, o, lse) and whose
    backward recomputes P from the lse -- the JAX `_flash_gqa` /
    `_flash_lm` custom VJPs."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal, scale, q_offset):
        if q.device.type == "cpu":
            out = attention_reference(q, k, v, kv_valid, causal, scale, q_offset)
            lse = attention_lse_reference(q, k, kv_valid, causal, scale, q_offset)
        else:
            out, lse = flash_attn_fwd(q, k, v, kv_valid, causal, scale,
                                      q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.args = (causal, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = attention_bwd_reference(q, k, v, kv_valid, out, dout, lse,
                                            *ctx.args)
            grads = [g.to(x.dtype) for g, x in zip(grads, (q, k, v))]
        else:
            grads = flash_attn_bwd(q, k, v, kv_valid, out, dout, lse, *ctx.args)
        return (*grads, None, None, None, None)


def attention_train(q, k, v, kv_valid=None, causal=True, scale=None,
                    q_offset=None):
    """`attention` with a backward: [B, T, HQ, D] x [B, S, HK, D]."""
    return _AttentionTrain.apply(q, k, v, kv_valid, causal, scale, q_offset)


def attention_autograd(q, k, v, kv_valid=None, causal=True, scale=None,
                       q_offset=None):
    """`attention_train` when autograd records through q/k/v (training),
    else the serving `attention` (no lse written, nothing saved)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return attention_train(q, k, v, kv_valid, causal, scale, q_offset)
    return attention(q, k, v, kv_valid, causal, scale, q_offset)

"""Flash attention forward with slot-order causality and key validity.

Counterpart of `simlingo_tpu/kernels/flash_attention.py`: one CUDA kernel
(`csrc/flash_attn_fwd.cu`) covers the three Pallas forward kernels --
`_fwd_kernel_gqa` (:308, the LLM), `_fwd_kernel_pair` (:786, the ViT read
from the flat projection output) and `_fwd_kernel` (:114, plain MHA).

Semantics (as `attention_reference` in the JAX package, :71-107):
  * q [B, T, HQ, D], k/v [B, S, HK, D]; query head h reads kv head
    h // (HQ // HK) (heads are kv-major);
  * causal masking is slot-order: query row i sits at slot i + q_offset and
    sees key slots <= that; q_offset None means S - T;
  * kv_valid [B, S] bool masks keys; a row with no visible valid key
    returns 0.

On a CUDA tensor `attention` launches the kernel (bf16, D = 64); on a CPU
tensor it runs `attention_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from simlingo_tpu_torch.kernels import _build

NEG_INF = -1e30


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
                   q_offset=None):
    """Launch the CUDA kernel. q/k/v may be strided views (e.g. heads of a
    [B, T, H*D] projection, or a KV cache); no copy is made."""
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
    if B * T == 0:
        return out
    lib = _lib()
    rc = lib.simlingo_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr, out.data_ptr(),
        B, T, S, HQ, HK,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), int(q_offset), ctypes.c_float(float(scale)),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attn_fwd")
    flash_attn_fwd.launches += 1
    return out


flash_attn_fwd.launches = 0


def _lib():
    lib = _build.load("flash_attn_fwd")
    fn = lib.simlingo_flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib

"""Qwen2 decoder-only LLM (the InternVL2-1B language tower), inference only.

Counterpart of `simlingo_tpu/models/qwen2.py`: RoPE + GQA decoder on input
embeddings, explicit position ids and key-validity mask, optional LoRA on
every linear, and a preallocated KV cache for prefill + cached decode.
There is no dropout and no training path in this slice.

Architecture constants (Qwen2-0.5B-Instruct inside InternVL2-1B): hidden
896, 24 layers, 14 query heads / 2 kv heads, head_dim 64, intermediate
4864, RMSNorm eps 1e-6, rope_theta 1e6, SwiGLU, qkv bias, tied embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from simlingo_tpu_torch.kernels.flash_attention import attention
from simlingo_tpu_torch.kernels.quantized_matmul import int8_matmul
from simlingo_tpu_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151674
    hidden_size: int = 896
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    head_dim: int = 64
    intermediate_size: int = 4864
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    tie_word_embeddings: bool = True
    qkv_bias: bool = True
    lora_r: int = 0
    lora_alpha: int = 0
    lora_dropout: float = 0.0

    @staticmethod
    def tiny(vocab_size: int = 512) -> "Qwen2Config":
        return Qwen2Config(vocab_size=vocab_size, hidden_size=64, num_layers=2,
                           num_heads=4, num_kv_heads=2, head_dim=16,
                           intermediate_size=128)


def init_params(gen: torch.Generator, cfg: Qwen2Config, dtype=torch.float32,
                device="cpu") -> Dict[str, Any]:
    H, D = cfg.hidden_size, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p: Dict[str, Any] = {
        "embed": {"w": L._normal(gen, (cfg.vocab_size, H), **kw)},
        "final_norm": L.rmsnorm_init(H, **kw),
        "layers": {},
    }
    if not cfg.tie_word_embeddings:
        p["lm_head"] = {"w": L._normal(gen, (cfg.vocab_size, H), **kw)}
    for i in range(cfg.num_layers):
        p["layers"][str(i)] = {
            "ln1": L.rmsnorm_init(H, **kw),
            "ln2": L.rmsnorm_init(H, **kw),
            "attn": {
                "q": L.linear_init(gen, H, cfg.num_heads * D, cfg.qkv_bias, **kw),
                "k": L.linear_init(gen, H, cfg.num_kv_heads * D, cfg.qkv_bias, **kw),
                "v": L.linear_init(gen, H, cfg.num_kv_heads * D, cfg.qkv_bias, **kw),
                "o": L.linear_init(gen, cfg.num_heads * D, H, False, **kw),
            },
            "mlp": {"gate": L.linear_init(gen, H, cfg.intermediate_size, False, **kw),
                    "up": L.linear_init(gen, H, cfg.intermediate_size, False, **kw),
                    "down": L.linear_init(gen, cfg.intermediate_size, H, False, **kw)},
        }
    return p


def merge_lora(params: Dict[str, Any], lora_params: Dict[str, Any],
               cfg: Qwen2Config) -> Dict[str, Any]:
    """Fold LoRA adapters into the base weights: W += (alpha/r) * B A, with
    A [r, in] and B [out, r] (peft layout). Returns a new tree."""
    scale = cfg.lora_alpha / cfg.lora_r
    out = dict(params, layers={i: {k: (dict(v) if isinstance(v, dict) else v)
                                   for k, v in lp.items()}
                               for i, lp in params["layers"].items()})
    for i, layer in lora_params["layers"].items():
        lp = out["layers"][i]
        for name, ab in layer.items():
            grp = "attn" if name in ("q", "k", "v", "o") else "mlp"
            tgt = dict(lp[grp][name])
            w = tgt["w"]
            tgt["w"] = w + (scale * (ab["b"].float() @ ab["a"].float())).to(w.dtype)
            lp[grp][name] = tgt
    return out


def _linear_maybe_lora(p, lora, x, cfg: Qwen2Config):
    y = L.linear(p, x)
    if lora is not None:
        scale = cfg.lora_alpha / cfg.lora_r
        y = y + scale * F.linear(F.linear(x, lora["a"].to(x.dtype)),
                                 lora["b"].to(x.dtype))
    return y


def _attn_block(p, lora, x, cfg: Qwen2Config, cos, sin, kv_valid, causal,
                cache=None, cache_index=None):
    B, T, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lr(name):
        return _linear_maybe_lora(p[name], lora.get(name) if lora else None,
                                  x, cfg)

    q = L.apply_rope(lr("q").view(B, T, nh, hd), cos, sin)
    k = L.apply_rope(lr("k").view(B, T, nkv, hd), cos, sin)
    v = lr("v").view(B, T, nkv, hd)
    q_offset = None
    if cache is not None:
        # The chunk's K/V are written into the preallocated cache IN PLACE
        # (JAX returns an updated copy via dynamic_update_slice); the chunk
        # must fit, which the runner's slot layout guarantees.
        if cache_index + T > cache["k"].shape[1]:
            raise ValueError(f"chunk of {T} at slot {cache_index} overruns the "
                             f"cache of {cache['k'].shape[1]} slots")
        cache["k"][:, cache_index:cache_index + T] = k.to(cache["k"].dtype)
        cache["v"][:, cache_index:cache_index + T] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        # q rows occupy slots [cache_index, cache_index + T)
        q_offset = cache_index
    out = attention(q, k, v, kv_valid, causal=causal, q_offset=q_offset)
    return _linear_maybe_lora(p["o"], lora.get("o") if lora else None,
                              out.reshape(B, T, nh * hd), cfg)


def _mlp_block(p, lora, x, cfg: Qwen2Config):
    def lr(name, inp):
        return _linear_maybe_lora(p[name], lora.get(name) if lora else None,
                                  inp, cfg)
    return lr("down", F.silu(lr("gate", x)) * lr("up", x))


def forward(params: Dict[str, Any], inputs_embeds: torch.Tensor,
            cfg: Qwen2Config, position_ids: torch.Tensor,
            kv_valid: Optional[torch.Tensor] = None, causal: bool = True,
            lora_params: Optional[Dict[str, Any]] = None,
            cache: Optional[Dict[str, Any]] = None
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Decoder stack on pre-built embeddings [B, T, H].

    cache: {"layers": {i: {"k", "v"} [B, max_len, HK, D]}, "index": int}; the
    chunk is written at slot `index` and the returned cache (the same
    buffers) has index advanced by T. Returns (final-normed hidden, cache).
    """
    x = inputs_embeds
    inv_freq = L.rope_frequencies(cfg.head_dim, cfg.rope_theta, x.device)
    cos, sin = L.rope_cos_sin(position_ids, inv_freq)
    if kv_valid is not None:     # the kernel's mask type, made once for all layers
        kv_valid = kv_valid.to(torch.uint8).contiguous()
    cache_index = int(cache["index"]) if cache is not None else None
    for i in range(cfg.num_layers):
        lp = params["layers"][str(i)]
        lo = lora_params["layers"].get(str(i)) if lora_params else None
        layer_cache = cache["layers"][str(i)] if cache is not None else None
        x = x + _attn_block(lp["attn"], lo, L.rmsnorm(lp["ln1"], x, cfg.rms_norm_eps),
                            cfg, cos, sin, kv_valid, causal, layer_cache,
                            cache_index)
        x = x + _mlp_block(lp["mlp"], lo, L.rmsnorm(lp["ln2"], x, cfg.rms_norm_eps),
                           cfg)
    if cache is not None:
        cache = dict(cache, index=cache_index + inputs_embeds.shape[1])
    return L.rmsnorm(params["final_norm"], x, cfg.rms_norm_eps), cache


def logits_from_hidden(params, hidden: torch.Tensor, cfg: Qwen2Config
                       ) -> torch.Tensor:
    """LM head: tied to the [V, H] embedding unless an lm_head exists; an
    int8 table runs the w8a16 kernel in the same [N, K] layout."""
    if "lm_head" in params:
        return L.linear(params["lm_head"], hidden)
    emb = params["embed"]
    if "w_q" in emb:
        return int8_matmul(hidden, emb["w_q"], emb["scale"])
    return F.linear(hidden, emb["w"].to(hidden.dtype))


def embed_tokens(params, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    return L.embed(params["embed"], ids, dtype=dtype)


def init_cache(cfg: Qwen2Config, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> Dict[str, Any]:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": {str(i): {"k": torch.zeros(shape, dtype=dtype, device=device),
                                "v": torch.zeros(shape, dtype=dtype, device=device)}
                       for i in range(cfg.num_layers)},
            "index": 0}

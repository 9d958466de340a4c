"""Qwen2 decoder-only LLM (the InternVL2-1B language tower).

Counterpart of `simlingo_tpu/models/qwen2.py`: RoPE + GQA decoder on input
embeddings, explicit position ids and key-validity mask, optional LoRA on
every linear, and a preallocated KV cache for prefill + cached decode.
Training (no cache, autograd on) runs attention through `attention_train`
and, with `dropout_seed`, LoRA dropout through the two autograd Functions
below, whose backwards regenerate the mask from the seed. The fused-LoRA
lever (`SIMLINGO_LORA_FUSED`, off in JAX) and the stacked / pipeline layer
layouts are not ported.

Architecture constants (Qwen2-0.5B-Instruct inside InternVL2-1B): hidden
896, 24 layers, 14 query heads / 2 kv heads, head_dim 64, intermediate
4864, RMSNorm eps 1e-6, rope_theta 1e6, SwiGLU, qkv bias, tied embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from simlingo_tpu_torch.kernels.dropout import dropout
from simlingo_tpu_torch.kernels.flash_attention import attention, attention_autograd
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


LORA_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


def init_lora_params(gen: torch.Generator, cfg: Qwen2Config,
                     dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """LoRA factors for every linear of every layer (peft "all-linear"), in
    the peft layout: A [r, in] kaiming-uniform U(+-1/sqrt(in)), B [out, r]
    zero, so the adapted model starts as the base model."""
    if cfg.lora_r <= 0:
        raise ValueError("init_lora_params needs lora_r > 0")
    H, D, r = cfg.hidden_size, cfg.head_dim, cfg.lora_r
    dims = {"q": (H, cfg.num_heads * D), "k": (H, cfg.num_kv_heads * D),
            "v": (H, cfg.num_kv_heads * D), "o": (cfg.num_heads * D, H),
            "gate": (H, cfg.intermediate_size), "up": (H, cfg.intermediate_size),
            "down": (cfg.intermediate_size, H)}
    layers = {}
    for i in range(cfg.num_layers):
        layers[str(i)] = {}
        for name in LORA_TARGETS:
            din, dout = dims[name]
            layers[str(i)][name] = {
                "a": L._uniform(gen, (r, din), din ** -0.5, dtype, device),
                "b": torch.zeros((dout, r), dtype=dtype, device=device)}
    return {"layers": layers}


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


def _lora_grads(xl, a, b, g):
    """(dA, dB, gb = g B) of (xl A^T) B^T, with peft-layout A [r, in] and
    B [out, r]."""
    gb = g @ b                                            # [..., r]
    xl2 = xl.reshape(-1, xl.shape[-1])
    da = gb.reshape(-1, gb.shape[-1]).t() @ xl2           # [r, in]
    db = g.reshape(-1, g.shape[-1]).t() @ (xl2 @ a.t())   # [out, r]
    return da, db, gb


class _LoraDropDelta(torch.autograd.Function):
    """(dropout(x) A^T) B^T (`qwen2.py:_lora_drop_delta` :149). The only
    tensor saved is x itself; the backward regenerates the mask from the
    seed and applies it to the gradient of the dropped input."""

    @staticmethod
    def forward(ctx, x, a, b, seed: int, rate: float):
        ctx.save_for_backward(x, a, b)
        ctx.seed, ctx.rate = seed, rate
        return F.linear(F.linear(dropout(x, seed, rate), a), b)

    @staticmethod
    def backward(ctx, g):
        x, a, b = ctx.saved_tensors
        xl = dropout(x, ctx.seed, ctx.rate)               # regenerated
        da, db, gb = _lora_grads(xl, a, b, g)
        dx = dropout(gb @ a, ctx.seed, ctx.rate)          # mask and scale are linear
        return dx, da, db, None, None


class _LoraDropDeltaGLU(torch.autograd.Function):
    """(dropout(silu(xg) * xu) A^T) B^T for the `down` adapter
    (`qwen2.py:_lora_drop_delta_glu` :183): the [B, T, intermediate]
    product is recomputed in the backward from xg and xu, never saved."""

    @staticmethod
    def forward(ctx, xg, xu, a, b, seed: int, rate: float):
        ctx.save_for_backward(xg, xu, a, b)
        ctx.seed, ctx.rate = seed, rate
        h = F.silu(xg) * xu
        return F.linear(F.linear(dropout(h, seed, rate), a), b)

    @staticmethod
    def backward(ctx, g):
        xg, xu, a, b = ctx.saved_tensors
        xg32 = xg.float()
        sg = torch.sigmoid(xg32)
        s = (xg32 * sg).to(xg.dtype)                      # silu(xg)
        xl = dropout(s * xu, ctx.seed, ctx.rate)
        da, db, gb = _lora_grads(xl, a, b, g)
        dh = dropout(gb @ a, ctx.seed, ctx.rate)
        # d silu(z)/dz = sigmoid(z) (1 + z (1 - sigmoid(z)))
        dsilu = (sg * (1 + xg32 * (1 - sg))).to(xg.dtype)
        return dh * xu * dsilu, dh * s, da, db, None, None


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def layer_seeds(step_seed: int, layer_idx: int) -> Dict[str, int]:
    """Seven independent 64-bit dropout seeds for one layer, one per LoRA
    target, derived on the host from the step's seed and the layer index
    by splitmix64 (the counterpart of `_layer_seeds` :376, which folds the
    layer into a JAX key; the streams differ)."""
    base = _splitmix64(int(step_seed) & 0xFFFFFFFFFFFFFFFF)
    return {name: _splitmix64(base ^ _splitmix64(layer_idx * len(LORA_TARGETS) + j))
            for j, name in enumerate(LORA_TARGETS)}


def _linear_maybe_lora(p, lora, x, cfg: Qwen2Config, seed=None):
    y = L.linear(p, x)
    if lora is not None:
        scale = cfg.lora_alpha / cfg.lora_r
        a, b = lora["a"].to(x.dtype), lora["b"].to(x.dtype)
        if seed is not None and cfg.lora_dropout > 0:
            y = y + scale * _LoraDropDelta.apply(x, a, b, seed, cfg.lora_dropout)
        else:
            y = y + scale * F.linear(F.linear(x, a), b)
    return y


def _attn_block(p, lora, x, cfg: Qwen2Config, cos, sin, kv_valid, causal,
                cache=None, cache_index=None, seeds=None):
    B, T, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lr(name):
        return _linear_maybe_lora(p[name], lora.get(name) if lora else None,
                                  x, cfg, seeds[name] if seeds else None)

    q = L.apply_rope(lr("q").view(B, T, nh, hd), cos, sin)
    k = L.apply_rope(lr("k").view(B, T, nkv, hd), cos, sin)
    v = lr("v").view(B, T, nkv, hd)
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
        out = attention(q, k, v, kv_valid, causal=causal, q_offset=cache_index)
    else:
        out = attention_autograd(q, k, v, kv_valid, causal=causal)
    return _linear_maybe_lora(p["o"], lora.get("o") if lora else None,
                              out.reshape(B, T, nh * hd), cfg,
                              seeds["o"] if seeds else None)


def _mlp_block(p, lora, x, cfg: Qwen2Config, seeds=None):
    def lr(name, inp):
        return _linear_maybe_lora(p[name], lora.get(name) if lora else None,
                                  inp, cfg, seeds[name] if seeds else None)

    down = lora.get("down") if lora else None
    if down is not None and seeds is not None and cfg.lora_dropout > 0:
        xg, xu = lr("gate", x), lr("up", x)
        y = L.linear(p["down"], F.silu(xg) * xu)
        return y + (cfg.lora_alpha / cfg.lora_r) * _LoraDropDeltaGLU.apply(
            xg, xu, down["a"].to(x.dtype), down["b"].to(x.dtype),
            seeds["down"], cfg.lora_dropout)
    return lr("down", F.silu(lr("gate", x)) * lr("up", x))


def forward(params: Dict[str, Any], inputs_embeds: torch.Tensor,
            cfg: Qwen2Config, position_ids: torch.Tensor,
            kv_valid: Optional[torch.Tensor] = None, causal: bool = True,
            lora_params: Optional[Dict[str, Any]] = None,
            cache: Optional[Dict[str, Any]] = None,
            dropout_seed: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Decoder stack on pre-built embeddings [B, T, H].

    cache: {"layers": {i: {"k", "v"} [B, max_len, HK, D]}, "index": int}; the
    chunk is written at slot `index` and the returned cache (the same
    buffers) has index advanced by T. Returns (final-normed hidden, cache).
    dropout_seed: the step's seed; with LoRA and lora_dropout > 0 every
    adapter's input is dropped out (training).
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
        seeds = (layer_seeds(dropout_seed, i) if dropout_seed is not None
                 and lo is not None and cfg.lora_dropout > 0 else None)
        x = x + _attn_block(lp["attn"], lo, L.rmsnorm(lp["ln1"], x, cfg.rms_norm_eps),
                            cfg, cos, sin, kv_valid, causal, layer_cache,
                            cache_index, seeds)
        x = x + _mlp_block(lp["mlp"], lo, L.rmsnorm(lp["ln2"], x, cfg.rms_norm_eps),
                           cfg, seeds)
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

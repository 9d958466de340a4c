"""Qwen2 decoder-only LLM (the InternVL2-1B language tower).

Counterpart of `simlingo_tpu/models/qwen2.py`: RoPE + GQA decoder on input
embeddings, explicit position ids and key-validity mask, optional LoRA on
every linear, and a preallocated KV cache for prefill + cached decode.
Training (no cache, autograd on) runs attention through `attention_train`
and, with `dropout_seed`, LoRA dropout through the two autograd Functions
below, whose backwards regenerate the mask from the seed. With `remat`
each decoder layer is checkpointed (torch.utils.checkpoint, non-reentrant)
and recomputed in the backward, as JAX's `jax.checkpoint` of `layer_fn`
(:471): the recompute launches the attention forward and the dropout
forwards again, and draws the same masks, since the seeds are host ints
(`layer_seeds`). The layers stay a dict of layers (JAX's stacked layout
is read by `core/from_jax.py`).

Fused LoRA groups (`SIMLINGO_LORA_FUSED=1`, `core/gates.py`; JAX's
`_fused_lora_delta` :241): where q, k and v (or gate and up) all have
adapters, the group's deltas come from one input through
`_LoraGroupDelta` or, without dropout, its plain products: one product
with the concatenated A [n r, in], then one with each adapter's B. JAX
multiplies by a block-diagonal B instead, whose off-diagonal zeros add
nothing; building it on every call would cost a `zeros` and n copies. With
dropout the group's input is dropped once, with the group's first seed
(`seeds["q"]`, `seeds["gate"]`), so the adapters share one mask, as in
JAX; `down` keeps its own (`_LoraDropDeltaGLU`). A group costs three
dropout launches a step (forward, the backward's regenerated mask, dx)
where its adapters cost 3 n, so a layer takes 4 x 3 where it took 7 x 3.

Tensor parallelism (`tp`, `models/layers.py`): at tp = t each rank holds
num_heads / t query heads and num_kv_heads / t kv heads (GQA groups
kept whole; q, k, v column-parallel, o row-parallel) and
intermediate_size / t of the SwiGLU (gate, up column, down row). A LoRA
adapter of a column-parallel linear uses the rank's rows of B, one of a
row-parallel linear the rank's columns of A; its delta joins the partial
output before the reduction. Dropout masks are placed in the whole
tensor (`kernels/dropout.py` blocks): the rank's batch rows
(`batch_offset`) and, at a row-parallel input, its columns, so every
rank draws the one-process mask of its block.

Sequence parallelism (`slab`, `parallel/sequence.py`): the inputs are this
rank's slab of every row; RoPE takes the slab's positions, attention runs
as the ring over the sp group, and each dropout mask is placed at the
slab's rows of the one-process tensor (segments of T / sp rows, T apart).
Pipeline parallelism (`parallel/pipeline.py`): with the pp context set
and no cache, `forward` runs only this stage's layers, keyed by their
global index, as a GPipe pipeline over microbatches, each microbatch's
dropout masks placed at its rows; the layers' own remat is the stage's
(`pipeline.enable(remat=...)`), as JAX's stacked forward ignores `remat`.
A stage's tree (not every layer) refuses the KV cache, as JAX's assert
(:444-446) refuses the stacked layout.

Architecture constants (Qwen2-0.5B-Instruct inside InternVL2-1B): hidden
896, 24 layers, 14 query heads / 2 kv heads, head_dim 64, intermediate
4864, RMSNorm eps 1e-6, rope_theta 1e6, SwiGLU, qkv bias, tied embeddings.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from simlingo_tpu_torch.core import gates
from simlingo_tpu_torch.kernels.dropout import dropout
from simlingo_tpu_torch.kernels.flash_attention import attention, attention_autograd
from simlingo_tpu_torch.kernels.quantized_matmul import int4_matmul, int8_matmul
from simlingo_tpu_torch.models import layers as L
from simlingo_tpu_torch.parallel import pipeline, sequence
from simlingo_tpu_torch.parallel.mesh import flatten, unflatten


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


class _LoraDropDeltaGLU(torch.autograd.Function):
    """(dropout(silu(xg) * xu) A^T) B^T for the `down` adapter
    (`qwen2.py:_lora_drop_delta_glu` :183): the [B, T, intermediate]
    product is recomputed in the backward from xg and xu, never saved."""

    @staticmethod
    def forward(ctx, xg, xu, a, b, seed: int, rate: float, block=None):
        ctx.save_for_backward(xg, xu, a, b)
        ctx.seed, ctx.rate, ctx.block = seed, rate, block
        h = F.silu(xg) * xu
        return F.linear(F.linear(dropout(h, seed, rate, block), a), b)

    @staticmethod
    def backward(ctx, g):
        xg, xu, a, b = ctx.saved_tensors
        xg32 = xg.float()
        sg = torch.sigmoid(xg32)
        s = (xg32 * sg).to(xg.dtype)                      # silu(xg)
        xl = dropout(s * xu, ctx.seed, ctx.rate, ctx.block)
        da, db, gb = _lora_grads(xl, a, b, g)
        dh = dropout(gb @ a, ctx.seed, ctx.rate, ctx.block)
        # d silu(z)/dz = sigmoid(z) (1 + z (1 - sigmoid(z)))
        dsilu = (sg * (1 + xg32 * (1 - sg))).to(xg.dtype)
        return dh * xu * dsilu, dh * s, da, db, None, None, None


def _cat(ts, dim=0):
    return ts[0] if len(ts) == 1 else torch.cat(ts, dim)


class _LoraGroupDelta(torch.autograd.Function):
    """The deltas (dropout(x) A_i^T) B_i^T of n >= 1 adapters that read one
    input x, with one mask for them (`qwen2.py:_lora_drop_delta` :149; a
    group of n, `_fused_lora_delta` :241). x is dropped by one launch; one
    product with A = [A_1; ...; A_n] [n r, in] gives every adapter's rank-r
    projection, and one product with each B_i its delta. The backward
    regenerates the mask from the seed (x is the only activation saved),
    takes dA of the group in one product, and drops the one dx by the same
    mask: three dropout launches for the n adapters. `block` places x in
    the whole tensor (`kernels/dropout.py`). Inputs after `block`: the n A
    factors (peft layout [r, in]), then the n B factors ([out_i, r]);
    returns n deltas."""

    @staticmethod
    def forward(ctx, x, seed: int, rate: float, block, *factors):
        n = len(factors) // 2
        a, bs = _cat(factors[:n]), factors[n:]
        r = factors[0].shape[0]
        u = F.linear(dropout(x, seed, rate, block), a)
        ctx.save_for_backward(x, a, *bs)
        ctx.seed, ctx.rate, ctx.block, ctx.r = seed, rate, block, r
        return tuple(F.linear(u[..., i * r:(i + 1) * r], b) for i, b in enumerate(bs))

    @staticmethod
    def backward(ctx, *gs):
        x, a, *bs = ctx.saved_tensors
        r = ctx.r
        xl = dropout(x, ctx.seed, ctx.rate, ctx.block)    # regenerated
        xl2 = xl.reshape(-1, xl.shape[-1])
        u = xl2 @ a.t()                                   # [rows, n r]
        gb = _cat([g @ b for g, b in zip(gs, bs)], -1)    # [..., n r]
        da = gb.reshape(-1, gb.shape[-1]).t() @ xl2       # [n r, in]
        dbs = [g.reshape(-1, g.shape[-1]).t() @ u[:, i * r:(i + 1) * r]
               for i, g in enumerate(gs)]                 # [out_i, r]
        dx = dropout(gb @ a, ctx.seed, ctx.rate, ctx.block)   # mask and scale are linear
        return (dx, None, None, None, *da.split(r), *dbs)


def _lora_group(p, lora, names, x, cfg: Qwen2Config, seed=None, tp=None, rows=0):
    """The column-parallel linears `names` of one input x, each its base
    output plus its delta of the group (`_LoraGroupDelta`; without dropout
    the same products, plain). Under `tp` each B is cut to this rank's
    output rows; x is replicated over tp, so the group's mask is the same
    on every tp rank."""
    a = [lora[n]["a"].to(x.dtype) for n in names]
    b = [lora[n]["b"].to(x.dtype) for n in names]
    if tp is not None:
        b = [L.tp_slice(t, 0, tp) for t in b]
    if seed is not None and cfg.lora_dropout > 0:
        deltas = _LoraGroupDelta.apply(x, seed, cfg.lora_dropout,
                                       _drop_block(x, rows, tp, "column"), *a, *b)
    else:
        r = a[0].shape[0]
        u = F.linear(x, torch.cat(a))
        deltas = [F.linear(u[..., i * r:(i + 1) * r], t) for i, t in enumerate(b)]
    scale = cfg.lora_alpha / cfg.lora_r
    return [L.linear(L.tp_params(p[n], "column", tp), x) + scale * d
            for n, d in zip(names, deltas)]


def _grouped(lora, names) -> bool:
    """Whether the adapters `names` run as one group: the gate on and each
    of them present (JAX :288-289, :340-341)."""
    return bool(lora) and all(lora.get(n) is not None for n in names) and gates.lora_fused()


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


def _drop_block(x: torch.Tensor, rows, tp, role: str):
    """Where x lies in the one-process tensor (`kernels/dropout.py`): its
    rows, an int row0 or (row0, seg, stride) (a slab of seg rows out of
    every stride), and at a row-parallel input under tp, this rank's
    columns."""
    cols = x.shape[-1]
    row0, seg, stride = (rows, 0, 0) if isinstance(rows, int) else rows
    col0, width = (tp.rank * cols, cols * tp.size) if tp is not None and role == "row" \
        else (0, cols)
    return (row0, col0, width, seg, stride) if seg != stride else (row0, col0, width)


def _linear_maybe_lora(p, lora, x, cfg: Qwen2Config, seed=None, tp=None,
                       role: str = "column", rows=0):
    """The base linear plus the LoRA delta. Under `tp`, `role` "column"
    (x replicated; this rank's output features) or "row" (x this rank's
    input features; the partial output all-reduced, then the bias)."""
    y = L.linear(L.tp_params(p, role, tp), x)
    if lora is not None:
        scale = cfg.lora_alpha / cfg.lora_r
        a, b = lora["a"].to(x.dtype), lora["b"].to(x.dtype)
        if tp is not None:
            a, b = (a, L.tp_slice(b, 0, tp)) if role == "column" else (L.tp_slice(a, 1, tp), b)
        if seed is not None and cfg.lora_dropout > 0:
            y = y + scale * _LoraGroupDelta.apply(x, seed, cfg.lora_dropout,
                                                  _drop_block(x, rows, tp, role), a, b)[0]
        else:
            y = y + scale * F.linear(F.linear(x, a), b)
    return L.row_finish(y, p, tp) if tp is not None and role == "row" else y


def _attn_block(p, lora, x, cfg: Qwen2Config, cos, sin, kv_valid, causal,
                cache=None, cache_index=None, seeds=None, tp=None, rows=0):
    B, T, _ = x.shape
    hd = cfg.head_dim
    if tp is not None and cache is not None:
        raise ValueError("the KV cache (serving) does not run under tp")
    x = L.tp_copy(x, tp)

    def lr(name):
        return _linear_maybe_lora(p[name], lora.get(name) if lora else None,
                                  x, cfg, seeds[name] if seeds else None, tp, "column", rows)

    if _grouped(lora, ("q", "k", "v")):
        q, k, v = _lora_group(p, lora, ("q", "k", "v"), x, cfg, seeds["q"] if seeds else None,
                              tp, rows)
    else:
        q, k, v = lr("q"), lr("k"), lr("v")
    nh, nkv = q.shape[-1] // hd, k.shape[-1] // hd      # this rank's heads
    q = L.apply_rope(q.view(B, T, nh, hd), cos, sin)
    k = L.apply_rope(k.view(B, T, nkv, hd), cos, sin)
    v = v.view(B, T, nkv, hd)
    if cache is not None:
        # The chunk's K/V are written into the preallocated cache IN PLACE
        # (JAX returns an updated copy via dynamic_update_slice); the chunk
        # must fit, which the runner's slot layout guarantees.
        if cache_index + T > cache["k"].shape[1]:
            raise ValueError(f"chunk of {T} at slot {cache_index} overruns the "
                             f"cache of {cache['k'].shape[1]} slots")
        cache["k"][:, cache_index:cache_index + T] = k.to(cache["k"].dtype)
        cache["v"][:, cache_index:cache_index + T] = v.to(cache["v"].dtype)
        # the cache keeps its dtype (bf16 by default, as JAX's); at an fp32
        # compute dtype its values widen exactly to q's, as JAX promotes them
        k, v = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
        # q rows occupy slots [cache_index, cache_index + T)
        out = attention(q, k, v, kv_valid, causal=causal, q_offset=cache_index)
    else:
        out = attention_autograd(q, k, v, kv_valid, causal=causal)
    return _linear_maybe_lora(p["o"], lora.get("o") if lora else None,
                              out.reshape(B, T, nh * hd), cfg,
                              seeds["o"] if seeds else None, tp, "row", rows)


def _mlp_block(p, lora, x, cfg: Qwen2Config, seeds=None, tp=None, rows=0):
    x = L.tp_copy(x, tp)

    def lr(name, inp, role):
        return _linear_maybe_lora(p[name], lora.get(name) if lora else None,
                                  inp, cfg, seeds[name] if seeds else None, tp, role, rows)

    if _grouped(lora, ("gate", "up")):
        xg, xu = _lora_group(p, lora, ("gate", "up"), x, cfg, seeds["gate"] if seeds else None,
                             tp, rows)
    else:
        xg, xu = lr("gate", x, "column"), lr("up", x, "column")
    down = lora.get("down") if lora else None
    if down is not None and seeds is not None and cfg.lora_dropout > 0:
        a, b = down["a"].to(x.dtype), down["b"].to(x.dtype)
        if tp is not None:
            a = L.tp_slice(a, 1, tp)
        y = L.linear(L.tp_params(p["down"], "row", tp), F.silu(xg) * xu)
        y = y + (cfg.lora_alpha / cfg.lora_r) * _LoraDropDeltaGLU.apply(
            xg, xu, a, b, seeds["down"], cfg.lora_dropout, _drop_block(xg, rows, tp, "row"))
        return y if tp is None else L.row_finish(y, p["down"], tp)
    return lr("down", F.silu(xg) * xu, "row")


def _decoder_layer(lp, lo, x, cfg: Qwen2Config, cos, sin, kv_valid, causal,
                   layer_cache, cache_index, seeds, tp=None, rows=0, slab=False):
    """One layer; `slab`: x is a sequence-parallel slab, whose attention runs
    as the ring (entered here, so that a recompute in the backward, by
    remat or the pipeline, routes as the forward did)."""
    with sequence.slab_region() if slab else contextlib.nullcontext():
        x = x + _attn_block(lp["attn"], lo, L.rmsnorm(lp["ln1"], x, cfg.rms_norm_eps),
                            cfg, cos, sin, kv_valid, causal, layer_cache, cache_index, seeds,
                            tp, rows)
    return x + _mlp_block(lp["mlp"], lo, L.rmsnorm(lp["ln2"], x, cfg.rms_norm_eps),
                          cfg, seeds, tp, rows)


def forward(params: Dict[str, Any], inputs_embeds: torch.Tensor,
            cfg: Qwen2Config, position_ids: torch.Tensor,
            kv_valid: Optional[torch.Tensor] = None, causal: bool = True,
            lora_params: Optional[Dict[str, Any]] = None,
            cache: Optional[Dict[str, Any]] = None,
            remat: bool = False,
            dropout_seed: Optional[int] = None,
            tp=None, batch_offset: int = 0,
            slab: Optional[Tuple[int, int]] = None
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Decoder stack on pre-built embeddings [B, T, H].

    cache: {"layers": {i: {"k", "v"} [B, max_len, HK, D]}, "index": int}; the
    chunk is written at slot `index` and the returned cache (the same
    buffers) has index advanced by T. Returns (final-normed hidden, cache).
    remat: recompute each layer in the backward (no cache, autograd on).
    dropout_seed: the step's seed; with LoRA and lora_dropout > 0 every
    adapter's input is dropped out (training).
    tp: the tp group or None; batch_offset: the first batch row of this
    rank's rows in the one-process batch (dropout masks).
    slab: (i, n): the inputs are slab i of n of each row's sequence
    (sequence parallelism; attention runs as the ring).
    Under the pp context (no cache) the tree holds this stage's layers and
    the forward runs them as a pipeline (module docstring).
    """
    x = inputs_embeds
    T = x.shape[1]
    inv_freq = L.rope_frequencies(cfg.head_dim, cfg.rope_theta, x.device)
    cos, sin = L.rope_cos_sin(position_ids, inv_freq)
    if kv_valid is not None:     # the kernel's mask type, made once for all layers
        kv_valid = kv_valid.to(torch.uint8).contiguous()
    if len(params["layers"]) < cfg.num_layers and (cache is not None
                                                   or pipeline.active_axis() is None):
        raise ValueError(f"a pipeline stage's tree ({len(params['layers'])} of "
                         f"{cfg.num_layers} layers) runs only inside the pipeline: it "
                         "has no KV-cache decode path")
    cache_index = int(cache["index"]) if cache is not None else None
    T_all, off = (T * slab[1], T * slab[0]) if slab is not None else (T, 0)

    def rows(b0: int):
        """The dropout rows of batch rows from b0 on (`_drop_block`)."""
        return (b0 * T_all + off, T, T_all)

    def seeds_of(i, lo):
        return (layer_seeds(dropout_seed, i) if dropout_seed is not None
                and lo is not None and cfg.lora_dropout > 0 else None)

    ring = slab is not None
    if cache is None and pipeline.active_axis() is not None:
        x = _pipelined(params, lora_params, x, cfg, cos, sin, kv_valid, causal,
                       seeds_of, tp, rows, batch_offset, ring)
    else:
        for i in range(cfg.num_layers):
            lp = params["layers"][str(i)]
            lo = lora_params["layers"].get(str(i)) if lora_params else None
            layer_cache = cache["layers"][str(i)] if cache is not None else None
            seeds = seeds_of(i, lo)
            if remat and cache is None and torch.is_grad_enabled():
                # the layer draws no torch random numbers: no RNG state to replay
                x = checkpoint(_decoder_layer, lp, lo, x, cfg, cos, sin, kv_valid,
                               causal, None, None, seeds, tp, rows(batch_offset), ring,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = _decoder_layer(lp, lo, x, cfg, cos, sin, kv_valid, causal,
                                   layer_cache, cache_index, seeds, tp, rows(batch_offset),
                                   ring)
    if cache is not None:
        cache = dict(cache, index=cache_index + inputs_embeds.shape[1])
    return L.rmsnorm(params["final_norm"], x, cfg.rms_norm_eps), cache


def _pipelined(params, lora_params, x, cfg: Qwen2Config, cos, sin, kv_valid, causal,
               seeds_of, tp, rows, batch_offset, ring):
    """This stage's layers over the pipeline (`parallel/pipeline.py`): stage
    s of S holds layers [s L / S, (s + 1) L / S)."""
    pp = pipeline.comm()
    per = cfg.num_layers // pp.size
    ids = [str(i) for i in range(pp.rank * per, (pp.rank + 1) * per)]
    pairs = [(f"p/{i}/{path}", t) for i in ids for path, t in flatten(params["layers"][i]).items()]
    if lora_params:
        pairs += [(f"l/{i}/{path}", t) for i in ids
                  for path, t in flatten(lora_params["layers"].get(i, {})).items()]
    names = [n for n, _ in pairs]
    mb = x.shape[0] // pipeline.microbatches(x.shape[0])

    def stage(x_mb, m, flat):
        tree = unflatten(dict(zip(names, flat)))
        sl = slice(m * mb, (m + 1) * mb)
        valid_m = kv_valid[sl] if kv_valid is not None else None
        for i in ids:
            lo = tree.get("l", {}).get(i)
            x_mb = _decoder_layer(tree["p"][i], lo, x_mb, cfg, cos[sl], sin[sl], valid_m,
                                  causal, None, None, seeds_of(int(i), lo), tp,
                                  rows(batch_offset + m * mb), ring)
        return x_mb

    # a later stage reads its input from the previous stage, not from x:
    # no cotangent for x there (so the ViT's backward runs on stage 0 alone)
    return pipeline.pipeline_layers(stage, x if pp.rank == 0 else x.detach(),
                                    [t for _, t in pairs])


def logits_from_hidden(params, hidden: torch.Tensor, cfg: Qwen2Config
                       ) -> torch.Tensor:
    """LM head: tied to the [V, H] embedding unless an lm_head exists; a
    quantized table takes the same [N, K] layout as the linears (int8: the
    w8a16 kernel; int4, its scale [V, G]: the w4a16 product, JAX's
    :525-528)."""
    if "lm_head" in params:
        return L.linear(params["lm_head"], hidden)
    emb = params["embed"]
    if "w_q" in emb:
        qmm = int4_matmul if emb["scale"].dim() == 2 else int8_matmul
        return qmm(hidden, emb["w_q"], emb["scale"])
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

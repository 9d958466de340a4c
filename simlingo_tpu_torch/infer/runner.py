"""Inference: prefill + KV-cached greedy decode + driving-query forward.

Counterpart of `simlingo_tpu/infer/runner.py`. The cache-slot layout is the
same (left-padded prompts, so every sample's prompt ends at T_prompt):

    [0 .. T_prompt)                    prompt (pads invalid)
    [T_prompt .. T_prompt + max_new)   generated tokens
    [T_prompt + max_new .. + n_query)  driving queries

RoPE positions are content-relative (n_valid + step); causal masking is
slot-order with q_offset = the chunk's first cache slot. The JAX
`lax.while_loop` becomes a Python loop that stops when every row has
emitted eos: one host sync per generated token.

Token selection (`sample_categorical`) follows JAX's order and tie rules:
the restriction masks the logits first (before the greedy argmax too);
then, when sampling, top-k keeps every logit >= the k-th largest (ties
included) before the temperature divides; top-p keeps the sorted tokens
while the cumulative probability before them is <= top_p (the first one
always) and then every logit >= the smallest kept one (ties included). The
draw is the Gumbel-max form of a categorical, as `jax.random.categorical`,
from a `torch.Generator` instead of a JAX key: the same distribution, not
the same stream.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from simlingo_tpu_torch.core.structs import DrivingInput, DrivingOutput
from simlingo_tpu_torch.models import adaptors as A
from simlingo_tpu_torch.models import qwen2, simlingo
from simlingo_tpu_torch.models.simlingo import SimLingoConfig


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 100
    eos_token_id: int = 151645          # <|im_end|> for InternVL2-1B chat
    cache_dtype: torch.dtype = torch.bfloat16
    temperature: float = 0.0            # <= 0: greedy argmax
    top_k: int = 0                      # 0: off
    top_p: float = 0.0                  # 0: off
    # sample only token ids [lo, lo + n)
    restrict_tokens: Optional[Tuple[int, int]] = None


def restrict(logits: torch.Tensor, cfg: GenerateConfig) -> torch.Tensor:
    """fp32 logits, -inf outside `cfg.restrict_tokens`."""
    logits = logits.float()
    if cfg.restrict_tokens is None:
        return logits
    lo, n = cfg.restrict_tokens
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill((ids < lo) | (ids >= lo + n), float("-inf"))


def filter_logits(logits: torch.Tensor, cfg: GenerateConfig) -> torch.Tensor:
    """The logits whose softmax a sampling step draws from (temperature >
    0): restricted, top-k thresholded, divided by the temperature, top-p
    thresholded; -inf outside the support."""
    logits = restrict(logits, cfg)
    neg = float("-inf")
    if cfg.top_k and cfg.top_k > 0:
        k = min(cfg.top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, neg)
    logits = logits / max(cfg.temperature, 1e-9)
    if cfg.top_p and cfg.top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        keep = torch.roll(cum <= cfg.top_p, 1, dims=-1)
        keep[..., 0] = True
        kept_min = torch.where(keep, sorted_logits, float("inf")).amin(-1, keepdim=True)
        logits = logits.masked_fill(logits < kept_min, neg)
    return logits


def sample_categorical(logits: torch.Tensor, cfg: GenerateConfig = GenerateConfig(),
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Next token ids [B] from logits [B, V]: the argmax (first index on
    ties) of the restricted logits when cfg.temperature <= 0, else a draw
    from softmax(filter_logits) with `generator` (on the logits' device)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(restrict(logits, cfg), dim=-1)
    logits = filter_logits(logits, cfg)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def _prefill(params, di: DrivingInput, cfg: SimLingoConfig,
             gen_cfg: GenerateConfig, compute_dtype):
    label = di.prompt_inference
    B, T_prompt = label.ids.shape
    max_new = gen_cfg.max_new_tokens
    max_len = T_prompt + max_new + cfg.num_queries
    embeds = simlingo.build_text_embeddings(params, label, di.pixel_values,
                                            cfg, dtype=compute_dtype)
    kv_valid = torch.zeros(B, max_len, dtype=torch.bool, device=embeds.device)
    kv_valid[:, :T_prompt] = label.valid
    cache = qwen2.init_cache(cfg.llm, B, max_len, dtype=gen_cfg.cache_dtype,
                             device=embeds.device)
    hidden, cache = qwen2.forward(params["llm"], embeds, cfg.llm,
                                  simlingo.text_positions(label),
                                  kv_valid=kv_valid, causal=True,
                                  lora_params=params.get("lora"), cache=cache)
    return hidden[:, -1].to(compute_dtype), kv_valid, cache


def _drive(params, cfg: SimLingoConfig, label, kv_valid, cache, gen_len,
           T_prompt: int, max_new: int, compute_dtype) -> Dict[str, torch.Tensor]:
    """The 30 driving queries through the cache at slots T_prompt + max_new."""
    B = kv_valid.shape[0]
    queries = A.query_tokens(params["adaptors"], B, dtype=compute_dtype)
    n_query = queries.shape[1]
    q_pos = ((label.num_valid + gen_len)[:, None]
             + torch.arange(n_query, device=queries.device))
    kv_valid_q = kv_valid.clone()
    kv_valid_q[:, T_prompt + max_new:] = True
    cache = dict(cache, index=T_prompt + max_new)
    qh, _ = qwen2.forward(params["llm"], queries, cfg.llm, q_pos,
                          kv_valid=kv_valid_q, causal=True,
                          lora_params=params.get("lora"), cache=cache)
    return A.decode_predictions(params["adaptors"], qh)


def generate_and_drive(params: Dict[str, Any], di: DrivingInput,
                       model_cfg: SimLingoConfig, gen_cfg: GenerateConfig,
                       compute_dtype=torch.bfloat16,
                       generator: Optional[torch.Generator] = None) -> DrivingOutput:
    """Language generation (greedy unless gen_cfg samples) + waypoint
    decoding. `di.prompt_inference` must be LEFT-padded. A sampling run
    draws from `generator` (None: one seeded 0 on the logits' device, as
    JAX's default key 0)."""
    cfg = model_cfg
    label = di.prompt_inference
    B, T_prompt = label.ids.shape
    max_new = gen_cfg.max_new_tokens
    eos = gen_cfg.eos_token_id
    last_h, kv_valid, cache = _prefill(params, di, cfg, gen_cfg, compute_dtype)
    dev = last_h.device
    n_valid = label.num_valid

    if gen_cfg.temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.full((B, max_new), eos, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    step = 0
    while step < max_new and not bool(done.all()):      # one host sync per token
        logits = qwen2.logits_from_hidden(params["llm"], last_h, cfg.llm)
        next_tok = sample_categorical(logits, gen_cfg, generator)
        next_tok = torch.where(done, torch.full_like(next_tok, eos), next_tok)
        tokens[:, step] = next_tok
        # the sampled token (eos included) joins the sequence
        kv_valid[:, T_prompt + step] = ~done
        emb = qwen2.embed_tokens(params["llm"], next_tok[:, None],
                                 dtype=compute_dtype)
        pos = (n_valid + step)[:, None]
        h, cache = qwen2.forward(params["llm"], emb, cfg.llm, pos,
                                 kv_valid=kv_valid, causal=True,
                                 lora_params=params.get("lora"),
                                 cache=dict(cache, index=T_prompt + step))
        done = done | (next_tok == eos)
        last_h = h[:, 0].to(compute_dtype)
        step += 1

    gen_len = kv_valid[:, T_prompt:T_prompt + max_new].sum(dim=1)
    preds = _drive(params, cfg, label, kv_valid, cache, gen_len, T_prompt,
                   max_new, compute_dtype)
    return DrivingOutput(speed_wps=preds["speed_wps"],
                         route=preds.get("route", torch.zeros(B, 0, 2, device=dev)),
                         language_tokens=tokens, language_lengths=gen_len)


def drive_only(params: Dict[str, Any], di: DrivingInput,
               model_cfg: SimLingoConfig,
               compute_dtype=torch.bfloat16) -> DrivingOutput:
    """Action-only path: one forward over [prompt | queries]."""
    cfg = model_cfg
    label = di.prompt_inference
    B = label.ids.shape[0]
    embeds, valid, pos = simlingo.assemble_sequence(
        params, label, di.pixel_values, cfg, dtype=compute_dtype)
    hidden, _ = qwen2.forward(params["llm"], embeds, cfg.llm, pos,
                              kv_valid=valid, causal=True,
                              lora_params=params.get("lora"))
    preds = A.decode_predictions(params["adaptors"], hidden[:, -cfg.num_queries:])
    dev = embeds.device
    return DrivingOutput(speed_wps=preds["speed_wps"],
                         route=preds.get("route", torch.zeros(B, 0, 2, device=dev)),
                         language_tokens=torch.zeros(B, 0, dtype=torch.long, device=dev),
                         language_lengths=torch.zeros(B, dtype=torch.long, device=dev))

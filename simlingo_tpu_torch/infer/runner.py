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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

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


def sample_categorical(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token selection (argmax, first index on ties). Temperature,
    top-k/top-p and token restriction are not ported in this slice."""
    return torch.argmax(logits.float(), dim=-1)


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
                       compute_dtype=torch.bfloat16) -> DrivingOutput:
    """Greedy language generation + waypoint decoding.
    `di.prompt_inference` must be LEFT-padded."""
    cfg = model_cfg
    label = di.prompt_inference
    B, T_prompt = label.ids.shape
    max_new = gen_cfg.max_new_tokens
    eos = gen_cfg.eos_token_id
    last_h, kv_valid, cache = _prefill(params, di, cfg, gen_cfg, compute_dtype)
    dev = last_h.device
    n_valid = label.num_valid

    tokens = torch.full((B, max_new), eos, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    step = 0
    while step < max_new and not bool(done.all()):      # one host sync per token
        logits = qwen2.logits_from_hidden(params["llm"], last_h, cfg.llm)
        next_tok = sample_categorical(logits)
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

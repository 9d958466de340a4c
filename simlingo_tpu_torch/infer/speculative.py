"""Speculative CoT decoding: n-gram draft + exact greedy verification.

Counterpart of `simlingo_tpu/infer/speculative.py`. Each round forwards the
pending token plus k-1 drafted tokens through the KV cache in one chunk and
keeps the drafts that equal the model's own argmax, so the emitted tokens
are identical to plain greedy decoding; only the number of LLM forwards
changes. The draft tables and the bookkeeping stay on the host (B = 1):
one host sync per round, on the verified tokens.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from simlingo_tpu_torch.core.structs import DrivingInput, DrivingOutput
from simlingo_tpu_torch.infer.runner import (GenerateConfig, _drive, _prefill,
                                             sample_categorical)
from simlingo_tpu_torch.models import qwen2
from simlingo_tpu_torch.models.simlingo import SimLingoConfig

_HASH_MULT = np.uint32(2654435761)     # Knuth multiplicative hash


def _bigram_hash(prev, cur, mask):
    """uint32-wrapping hash, identical to the JAX package's."""
    return ((np.asarray(prev, np.uint32) * _HASH_MULT)
            ^ np.asarray(cur, np.uint32)) & mask


def build_draft_tables(seqs: Sequence[Sequence[int]], vocab_size: int,
                       table_bits: int = 15) -> Dict[str, np.ndarray]:
    """Order-2 (direct-mapped, hashed) + order-1 next-token tables; on a
    slot collision the more frequent context wins; empty entries draft
    vocab_size - 1."""
    M = 1 << table_bits
    mask = np.uint32(M - 1)
    bi_counts: Dict[tuple, Counter] = defaultdict(Counter)
    uni_counts: Dict[int, Counter] = defaultdict(Counter)
    for seq in seqs:
        for i in range(len(seq) - 1):
            uni_counts[seq[i]][seq[i + 1]] += 1
            if i >= 1:
                bi_counts[(seq[i - 1], seq[i])][seq[i + 1]] += 1
    sentinel = vocab_size - 1
    uni = np.full((vocab_size,), sentinel, np.int32)
    for cur, ctr in uni_counts.items():
        if 0 <= cur < vocab_size:
            uni[cur] = ctr.most_common(1)[0][0]
    bi_prev = np.full((M,), -1, np.int32)
    bi_cur = np.full((M,), -1, np.int32)
    bi_next = np.full((M,), sentinel, np.int32)
    for (prev, cur), ctr in sorted(bi_counts.items(),
                                   key=lambda kv: sum(kv[1].values())):
        h = int(_bigram_hash(np.int32(prev), np.int32(cur), mask))
        bi_prev[h], bi_cur[h] = prev, cur
        bi_next[h] = ctr.most_common(1)[0][0]
    return {"uni": uni, "bi_prev": bi_prev, "bi_cur": bi_cur, "bi_next": bi_next}


def propose(draft: Dict[str, np.ndarray], prev: int, cur: int, n: int
            ) -> List[int]:
    """Chain n draft tokens from the context (prev, cur)."""
    mask = np.uint32(draft["bi_prev"].shape[0] - 1)
    out = []
    for _ in range(n):
        h = int(_bigram_hash(prev, cur, mask))
        hit = draft["bi_prev"][h] == prev and draft["bi_cur"][h] == cur
        nxt = int(draft["bi_next"][h] if hit else draft["uni"][cur])
        out.append(nxt)
        prev, cur = cur, nxt
    return out


def generate_and_drive_spec(params: Dict[str, Any], di: DrivingInput,
                            model_cfg: SimLingoConfig, gen_cfg: GenerateConfig,
                            draft: Dict[str, np.ndarray], spec_k: int = 4,
                            compute_dtype=torch.bfloat16,
                            return_stats: bool = False):
    """Speculative counterpart of runner.generate_and_drive (greedy, B=1).
    return_stats=True also returns {"rounds", "gen_len"}."""
    cfg = model_cfg
    label = di.prompt_inference
    B, T_prompt = label.ids.shape
    if B != 1:
        raise ValueError("speculative decode serves the closed-loop agent (B=1)")
    max_new = gen_cfg.max_new_tokens
    k = max(2, min(spec_k, max_new))
    eos = gen_cfg.eos_token_id
    llm = params["llm"]

    last_h, kv_valid, cache = _prefill(params, di, cfg, gen_cfg, compute_dtype)
    dev = last_h.device
    n_valid = int(label.num_valid[0])
    t0 = int(sample_categorical(qwen2.logits_from_hidden(llm, last_h, cfg.llm))[0])
    tokens = [eos] * max_new
    tokens[0] = t0
    pending, prev = t0, int(label.ids[0, -1])
    m, rounds, done = 1, 0, t0 == eos
    while m < max_new and not done:
        chunk = [pending] + propose(draft, prev, pending, k - 1)
        s = T_prompt + m - 1                      # slot of the pending token
        kv_tmp = kv_valid.clone()
        kv_tmp[:, s:s + k] = True
        emb = qwen2.embed_tokens(llm, torch.tensor([chunk], device=dev),
                                 dtype=compute_dtype)
        pos = n_valid + (m - 1) + torch.arange(k, device=dev)[None, :]
        h, cache = qwen2.forward(llm, emb, cfg.llm, pos, kv_valid=kv_tmp,
                                 causal=True, lora_params=params.get("lora"),
                                 cache=dict(cache, index=s))
        logits = qwen2.logits_from_hidden(llm, h.to(compute_dtype), cfg.llm)
        true_next = sample_categorical(logits)[0].tolist()   # host sync
        # accepted drafts + the model's correction, cut at eos and budget
        acc = 0
        while acc < k - 1 and chunk[acc + 1] == true_next[acc]:
            acc += 1
        c = acc + 1
        if eos in true_next:
            c = min(c, true_next.index(eos) + 1)
        c = min(c, max_new - m)
        tokens[m:m + c] = true_next[:c]
        kv_valid[:, s:s + c] = True               # chunk slots with correct KV
        prev = true_next[c - 2] if c >= 2 else pending
        pending = true_next[c - 1]
        done = eos in true_next[:c]
        m += c
        rounds += 1

    # flush: the last emitted token's KV is not in the cache yet
    s_f = T_prompt + m - 1
    kv_valid[:, s_f] = True
    emb_f = qwen2.embed_tokens(llm, torch.tensor([[pending]], device=dev),
                               dtype=compute_dtype)
    pos_f = torch.tensor([[n_valid + m - 1]], device=dev)
    _, cache = qwen2.forward(llm, emb_f, cfg.llm, pos_f, kv_valid=kv_valid,
                             causal=True, lora_params=params.get("lora"),
                             cache=dict(cache, index=s_f))
    gen_len = torch.tensor([m], device=dev)
    preds = _drive(params, cfg, label, kv_valid, cache, gen_len, T_prompt,
                   max_new, compute_dtype)
    out = DrivingOutput(speed_wps=preds["speed_wps"],
                        route=preds.get("route", torch.zeros(B, 0, 2, device=dev)),
                        language_tokens=torch.tensor([tokens], device=dev),
                        language_lengths=gen_len)
    if return_stats:
        return out, {"rounds": rounds, "gen_len": m}
    return out

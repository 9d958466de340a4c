"""From-scratch LLaMA backbone of SimLingo-Base (CarLLaVA).

Counterpart of `simlingo_tpu/models/llama.py`: the size table of the
reference's from-scratch LlamaModel configs (the base model uses `tiny`)
on continuous token embeddings only. LLaMA is a Qwen2 without qkv biases,
so the decoder is the port's `models/qwen2.py` with qkv_bias=False and
rope_theta 1e4; a 1-row embedding stands in for the removed vocabulary
(never read). The variants past `tiny` have head_dim 128 (`debug` 16),
which the attention kernels are built at.
"""

from __future__ import annotations

from typing import Dict

from simlingo_tpu_torch.models.qwen2 import Qwen2Config

# `simlingo_tpu/models/llama.py:25-38`; num_kv_heads defaults to heads
CONFIGS: Dict[str, Dict[str, int]] = {
    "debug": dict(num_layers=2, num_heads=2, hidden_size=32, intermediate_size=64),
    "tiny": dict(num_layers=12, num_heads=8, hidden_size=512, intermediate_size=2048),
    "x-small": dict(num_layers=14, num_heads=8, hidden_size=1024, intermediate_size=4096),
    "small": dict(num_layers=22, num_heads=8, hidden_size=1024, intermediate_size=4096),
    "medium": dict(num_layers=22, num_heads=12, hidden_size=1536, intermediate_size=4096),
    "large": dict(num_layers=22, num_heads=16, hidden_size=2048, intermediate_size=5632),
}


def llama_config(variant: str, num_kv_heads: int = 0) -> Qwen2Config:
    c = CONFIGS[variant]
    heads = c["num_heads"]
    return Qwen2Config(
        vocab_size=1,                       # vocabulary removed
        hidden_size=c["hidden_size"],
        num_layers=c["num_layers"],
        num_heads=heads,
        num_kv_heads=num_kv_heads or heads,
        head_dim=c["hidden_size"] // heads,
        intermediate_size=c["intermediate_size"],
        rope_theta=1e4,
        tie_word_embeddings=True,
        qkv_bias=False,
    )

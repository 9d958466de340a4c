"""Model-size presets.

Counterpart of `simlingo_tpu/core/presets.py:internvl2_1b`: the reference
production model (simlingo_seed1.yaml: OpenGVLab/InternVL2-1B =
InternViT-300M-448px + Qwen2-0.5B, LoRA r=32 alpha=64 dropout 0.1 on all
linears). The ViT uses the tanh form of GELU, as the JAX preset does,
and remat stays on in both towers, `SimLingoConfig`'s default: the JAX
preset does not turn it off (only `tiny()`, the tests' configs and
`bench.py`'s default BENCH_REMAT=0 do, :221-225). A caller that mirrors
`bench.py` passes this preset with `remat_vision=False, remat_llm=False`.

`simlingo_base` is the base trainer's configuration: the experiment
`configs/simlingo_base.yaml` composed over `BaseTrainConfig()`, as
`train_base.py --experiment configs/simlingo_base.yaml` composes it.
"""

from __future__ import annotations

import os

from simlingo_tpu_torch.models.qwen2 import Qwen2Config
from simlingo_tpu_torch.models.simlingo import SimLingoConfig
from simlingo_tpu_torch.models.vit import ViTConfig


def internvl2_1b(lora: bool = True, vocab_size: int = 151674) -> SimLingoConfig:
    return SimLingoConfig(
        vit=ViTConfig(gelu_approximate=True),
        llm=Qwen2Config(
            vocab_size=vocab_size,
            lora_r=32 if lora else 0,
            lora_alpha=64 if lora else 0,
            lora_dropout=0.1 if lora else 0.0,
        ),
        img_context_token_id=151648,
        speed_wps_mode="2d",
        predict_route_as_wps=True,
    )


SIMLINGO_BASE_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "..", "..", "configs", "simlingo_base.yaml")


def simlingo_base():
    """`configs/simlingo_base.yaml` over `BaseTrainConfig()`: seed 42, AdamW
    lr 1e-4, OneCycle pct_start 0.05, grad clip 1.0, batch 16; the model is
    `SimLingoBaseConfig()` (LLaVA-NeXT CLIP tower, tiny LLaMA)."""
    from simlingo_tpu_torch.core.config import compose_base
    return compose_base(os.path.normpath(SIMLINGO_BASE_YAML))

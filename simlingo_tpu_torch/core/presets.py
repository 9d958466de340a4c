"""Model-size presets.

Counterpart of `simlingo_tpu/core/presets.py:internvl2_1b`: the reference
production model (simlingo_seed1.yaml: OpenGVLab/InternVL2-1B =
InternViT-300M-448px + Qwen2-0.5B, LoRA r=32 alpha=64 dropout 0.1 on all
linears). The ViT uses the tanh form of GELU, as the JAX preset does.
The port has no remat, so the preset is the JAX one with remat off (the
training benchmark's default, `bench.py`).
"""

from __future__ import annotations

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

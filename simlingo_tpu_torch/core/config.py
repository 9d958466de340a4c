"""Training configuration and dotted `key=value` overrides.

Counterpart of the parts of `simlingo_tpu/core/config.py` that the
synthetic training loop reads: `TrainConfig` and the CLI override rule
(`_coerce`, `_apply`). The YAML overlay, the dataset options, mesh,
checkpoint and logging fields are not ported (ROADMAP A11-A13, A16).

The default model is `presets.internvl2_1b(lora=True)`, the configuration
the JAX training benchmark runs (`bench.py`), not `SimLingoConfig()`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional

from simlingo_tpu_torch.core import presets
from simlingo_tpu_torch.models.simlingo import SimLingoConfig
from simlingo_tpu_torch.train.train_step import OptimizerConfig


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 6
    max_text_len: int = 768


@dataclasses.dataclass
class TrainConfig:
    seed: int = 42
    max_steps: int = -1                # <= 0: 100 steps
    precision: str = "bf16"            # compute dtype (fp32 masters)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: SimLingoConfig = dataclasses.field(
        default_factory=lambda: presets.internvl2_1b(lora=True))
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if value.lower() in ("null", "none"):
        return None
    try:
        return json.loads(value)
    except ValueError:
        return value


def apply_override(cfg: Any, dotted: str, value: str) -> None:
    """Set `a.b.c` from a string, coerced to the current value's type (frozen
    dataclasses included, as the JAX `_apply` does)."""
    *parents, last = dotted.split(".")
    obj = cfg
    for p in parents:
        obj = getattr(obj, p)
    if not dataclasses.is_dataclass(obj) or not hasattr(obj, last):
        raise KeyError(f"unknown config key {dotted!r}")
    object.__setattr__(obj, last, _coerce(value, getattr(obj, last)))


def compose(overrides: Optional[List[str]] = None) -> TrainConfig:
    """TrainConfig defaults <- `key=value` overrides."""
    cfg = TrainConfig()
    for ov in overrides or []:
        key, sep, value = ov.partition("=")
        if not sep:
            raise ValueError(f"override {ov!r} is not key=value")
        apply_override(cfg, key, value)
    return cfg

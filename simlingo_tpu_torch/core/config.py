"""Training configuration: typed dataclasses <- YAML experiment <- dotted overrides.

Counterpart of `simlingo_tpu/core/config.py`: `MeshConfig`, `DataConfig`
and `TrainConfig` (:20-70) with the same fields and defaults, `load_yaml`
(:129: PyYAML, else JSON), `compose` (:139: defaults <- an experiment file
such as `configs/simlingo.yaml` <- `key=value` overrides) and `to_dict`.
`compose` also takes the list of overrides as its first argument.

The default model is `SimLingoConfig()`, as JAX's (:66): remat on in
both towers, no LoRA, the exact GELU; `configs/simlingo.yaml` has no
`model:` section, so `train_torch.py --experiment configs/simlingo.yaml`
trains the model that `train.py` trains. `model.remat_vision` and
`model.remat_llm` compose as JAX's do (a string onto the bool default is
read as a bool, so "mlp" is set from code, as `bench.py` sets it). One
difference from JAX: an unknown key raises KeyError. `MeshConfig`'s dp,
fsdp, tp, sp and pp lay the trainer's ranks out (`parallel/mesh.py`; dp -1
fills the processes); sp cuts the LLM's sequence (`parallel/sequence.py`),
pp its layers, over `pp_microbatches` microbatches
(`parallel/pipeline.py`).
`BaseTrainConfig` holds the fields of `TrainConfig` that `train_base.py`
reads for SimLingo-Base, with the same defaults (its model is
`SimLingoBaseConfig()`, its mesh dp x fsdp x tp); `compose_base` composes it
as `train_base.py:40` composes `TrainConfig` (defaults <- experiment <-
overrides).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Union

from simlingo_tpu_torch.data.driving_dataset import DrivingDatasetConfig
from simlingo_tpu_torch.models.simlingo import SimLingoConfig
from simlingo_tpu_torch.models.simlingo_base import SimLingoBaseConfig
from simlingo_tpu_torch.train.train_step import OptimizerConfig


@dataclasses.dataclass
class MeshConfig:
    dp: int = -1       # -1 => fill remaining devices
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    pp_microbatches: int = 0

    def check_supported(self) -> None:
        """The port lays ranks out over all five axes (`parallel/mesh.py`):
        every size but dp's -1 (fill) must be at least 1, and
        pp_microbatches (0: one a stage, as JAX's `_num_microbatches`)
        at least 0."""
        bad = {k: v for k, v in (("dp", self.dp), ("fsdp", self.fsdp), ("tp", self.tp),
                                 ("sp", self.sp), ("pp", self.pp))
               if v < 1 and not (k == "dp" and v == -1)}
        if bad or self.pp_microbatches < 0:
            raise ValueError(f"mesh {bad or {'pp_microbatches': self.pp_microbatches}}: "
                             "axis sizes are >= 1 (dp -1 fills the processes), "
                             "pp_microbatches >= 0")


@dataclasses.dataclass
class DataConfig:
    data_root: str = "database/simlingo"
    bucket_path: Optional[str] = None
    batch_size: int = 6
    num_workers: int = 8
    # bucket name -> weight (None => one 'all' bucket)
    train_partitions: Optional[Dict[str, float]] = None
    train_partitions_dreamer: Optional[Dict[str, float]] = None
    use_dreamer: bool = False
    max_text_len: int = 768
    base: DrivingDatasetConfig = dataclasses.field(
        default_factory=lambda: DrivingDatasetConfig(data_root=""))


@dataclasses.dataclass
class TrainConfig:
    seed: int = 42
    name: str = "simlingo_tpu"
    output_dir: str = "outputs"
    max_epochs: int = 15
    max_steps: int = -1                # <= 0: max_epochs (disk) or 100 (synthetic)
    val_every_n_epochs: int = 2        # 0 disables the validation loop
    val_max_batches: int = -1          # -1 = the whole validation split
    checkpoint_every_n_steps: int = 2000
    keep_checkpoints: int = 3
    log_every_n_steps: int = 50
    visualise_every_n_steps: int = 1000
    precision: str = "bf16"            # compute dtype (fp32 masters)
    resume: bool = False
    tokenizer_path: Optional[str] = None
    hf_checkpoint: Optional[str] = None   # initial weights from an HF / torch file
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: SimLingoConfig = dataclasses.field(default_factory=SimLingoConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)


@dataclasses.dataclass
class BaseTrainConfig:
    seed: int = 42
    name: str = "simlingo_tpu"
    # the run writes <output_dir>/<name>_base/config.json and its final
    # checkpoint under checkpoints/ there; "" writes nothing
    output_dir: str = "outputs"
    max_epochs: int = 15               # read by no synthetic run (as in train_base.py)
    max_steps: int = -1                # <= 0: 100 steps
    log_every_n_steps: int = 50
    precision: str = "bf16"            # compute dtype (fp32 masters)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: SimLingoBaseConfig = dataclasses.field(default_factory=SimLingoBaseConfig)
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


def apply_override(cfg: Any, dotted: str, value: Any) -> None:
    """Set `a.b.c` on dataclasses (frozen ones too, as the JAX `_apply`
    does) or dicts; a string is coerced to the current value's type."""
    *parents, last = dotted.split(".")
    obj = cfg
    for p in parents:
        if dataclasses.is_dataclass(obj) and hasattr(obj, p):
            obj = getattr(obj, p)
        elif isinstance(obj, dict) and p in obj:
            obj = obj[p]
        else:
            raise KeyError(f"unknown config key {dotted!r}")
    if isinstance(obj, dict):
        obj[last] = value
        return
    if not dataclasses.is_dataclass(obj) or not hasattr(obj, last):
        raise KeyError(f"unknown config key {dotted!r}")
    if isinstance(value, str):
        value = _coerce(value, getattr(obj, last))
    object.__setattr__(obj, last, value)


def _apply_tree(cfg: Any, tree: Dict[str, Any], prefix: str = "") -> None:
    """A nested mapping (a YAML file) onto the config: a dict descends where
    the target is a dataclass and replaces a plain dict field whole."""
    for k, v in tree.items():
        dotted = f"{prefix}{k}"
        if isinstance(v, dict):
            target = cfg
            for p in dotted.split("."):
                target = getattr(target, p, None) if dataclasses.is_dataclass(target) \
                    else None
            if dataclasses.is_dataclass(target):
                _apply_tree(cfg, v, dotted + ".")
                continue
        apply_override(cfg, dotted, v)


def _apply_all(cfg, overrides: Optional[List[str]]):
    for ov in overrides or []:
        key, sep, value = ov.partition("=")
        if not sep:
            raise ValueError(f"override {ov!r} is not key=value")
        apply_override(cfg, key, value)
    return cfg


def load_yaml(path: str) -> Dict[str, Any]:
    """PyYAML where it is installed, else the file read as JSON."""
    try:
        import yaml
    except ImportError:
        with open(path) as f:
            return json.load(f)
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _compose(cfg, experiment, overrides, config_dir):
    if isinstance(experiment, (list, tuple)):
        experiment, overrides = None, list(experiment) + list(overrides or [])
    if experiment:
        path = experiment if os.path.isfile(experiment) else os.path.join(
            config_dir, f"{experiment}.yaml")
        _apply_tree(cfg, load_yaml(path))
    return _apply_all(cfg, overrides)


def compose(experiment: Union[None, str, List[str]] = None,
            overrides: Optional[List[str]] = None,
            config_dir: str = "configs") -> TrainConfig:
    """TrainConfig defaults <- configs/<experiment>.yaml (or a path) <-
    `key=value` overrides. `compose([...])` takes the list as overrides."""
    return _compose(TrainConfig(), experiment, overrides, config_dir)


def compose_base(experiment: Union[None, str, List[str]] = None,
                 overrides: Optional[List[str]] = None,
                 config_dir: str = "configs") -> BaseTrainConfig:
    """BaseTrainConfig defaults <- an experiment (e.g.
    configs/simlingo_base.yaml) <- overrides, as `compose`."""
    return _compose(BaseTrainConfig(), experiment, overrides, config_dir)


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg

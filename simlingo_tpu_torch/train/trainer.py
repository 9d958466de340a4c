"""Training loops on synthetic batches.

`train` is the counterpart of the synthetic branch of
`simlingo_tpu/train/trainer.py:_train_impl` (:229-321): parameters from a
seed (or given), the trainable partition, AdamW + OneCycle, and
`max_steps` steps on one `synthetic_example` batch of 2 image tiles per
sample, printing loss, grad norm and ms per step. `train_base` is the
loop of `train_base.py` (SimLingo-Base): a fresh `base_batch` a step from
`RandomState(seed)`, the two-group step of `train/base_step.py`. The disk
data path, prefetching, checkpoints, logging, validation and
visualisation are not ported (ROADMAP A11, A12, A16).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from simlingo_tpu_torch.core import gates
from simlingo_tpu_torch.core.config import BaseTrainConfig, TrainConfig
from simlingo_tpu_torch.core.device import resolve_device
from simlingo_tpu_torch.data.synthetic import base_batch, synthetic_example
from simlingo_tpu_torch.models import simlingo, simlingo_base
from simlingo_tpu_torch.train import base_step
from simlingo_tpu_torch.train import train_step as ts


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of one step (qwen2.layer_seeds hashes it further)."""
    return (seed << 32) ^ step


def train(cfg: TrainConfig, params: Optional[Dict[str, Any]] = None,
          device="cuda",
          after_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
          trainable_fn: Callable[[str], bool] = ts.production_trainable
          ) -> Dict[str, Any]:
    """Run `cfg.max_steps` steps. Returns the state, the step function, the
    batch and the per-step records ({step, ms, loss, grad_norm, ...})."""
    dev = resolve_device(device)
    print(f"gates {gates.resolved()}", flush=True)
    compute_dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    model_cfg = cfg.model
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        params = simlingo.init_params(model_cfg, gen, device=dev)
    state = ts.init_train_state(params, cfg.optimizer, trainable_fn)
    del params
    n_train = sum(x.numel() for x in state.trainable.values())
    n_all = sum(x.numel() for x in ts.flatten(state.params).values())
    print(f"params {n_all / 1e6:.2f} M, trainable {n_train / 1e6:.2f} M", flush=True)
    step_fn = ts.make_train_step(model_cfg, cfg.optimizer, compute_dtype, trainable_fn)
    batch = synthetic_example(model_cfg, batch=cfg.data.batch_size,
                              seq_len=cfg.data.max_text_len,
                              num_patches=2, device=dev)
    total = cfg.max_steps if cfg.max_steps > 0 else 100
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    records = []
    for step in range(total):
        sync()
        t0 = time.perf_counter()
        metrics = step_fn(state, batch, step_seed(cfg.seed, step))
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        host = {k: float(v) for k, v in metrics.items()}
        records.append(dict(step=step + 1, ms=ms, **host))
        print(f"step {step + 1}/{total} loss={host['loss']:.4f} "
              f"grad_norm={host['grad_norm']:.4f} {ms:.1f} ms "
              f"({cfg.data.batch_size * 1e3 / ms:.2f} samples/s)", flush=True)
        if after_step is not None:
            after_step(step, host)
    return dict(state=state, step_fn=step_fn, batch=batch, records=records)


def train_base(cfg: BaseTrainConfig, params: Optional[Dict[str, Any]] = None,
               device="cuda",
               after_step: Optional[Callable[[int, Dict[str, float]], None]] = None
               ) -> Dict[str, Any]:
    """Run `cfg.max_steps` SimLingo-Base steps, each on a new batch. Returns
    the state, the step function, the last batch and the per-step records
    ({step, ms, batch_ms, loss, route_loss, speed_wps_loss, grad_norm_*}):
    ms is the step alone, batch_ms the batch's draw and copy before it."""
    dev = resolve_device(device)
    print(f"gates {gates.resolved()}", flush=True)
    compute_dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        params = simlingo_base.init_params(cfg.model, gen, device=dev)
    state = base_step.init_base_state(params, cfg.optimizer)
    del params
    sizes = {g: sum(x.numel() for x in xs) / 1e6 for g, xs in state.groups.items()}
    print(f"params {sum(sizes.values()):.2f} M (vision {sizes['vision']:.2f} M at lr x "
          f"{base_step.VISION_LR_SCALE}, rest {sizes['rest']:.2f} M)", flush=True)
    step_fn = base_step.make_base_train_step(cfg.model, cfg.optimizer, compute_dtype)
    total = cfg.max_steps if cfg.max_steps > 0 else 100
    B, S = cfg.data.batch_size, cfg.model.clip.image_size
    rng = np.random.RandomState(cfg.seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    records = []
    for step in range(total):
        t0 = time.perf_counter()
        batch = base_batch(rng, B, S, device=dev)
        sync()
        t1 = time.perf_counter()
        metrics = step_fn(state, batch)
        sync()
        ms = (time.perf_counter() - t1) * 1e3
        host = {k: float(v) for k, v in metrics.items()}
        records.append(dict(step=step + 1, ms=ms, batch_ms=(t1 - t0) * 1e3, **host))
        if (step + 1) % cfg.log_every_n_steps == 0 or step == 0 or step + 1 == total:
            # `train_base.py:104-106` logs speed_wps_loss as the loss
            print(f"step {step + 1}/{total} loss={host['speed_wps_loss']:.4f} "
                  f"(total {host['loss']:.4f}, grad norms vision "
                  f"{host['grad_norm_vision']:.4f} rest {host['grad_norm_rest']:.4f}) "
                  f"{ms:.1f} ms ({B * 1e3 / ms:.2f} samples/s)", flush=True)
        if after_step is not None:
            after_step(step, host)
    print("done (no checkpoint saved: checkpoints are not ported, ROADMAP A11)", flush=True)
    return dict(state=state, step_fn=step_fn, batch=batch, records=records)

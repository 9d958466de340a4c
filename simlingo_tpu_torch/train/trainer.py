"""Training loop on synthetic batches.

Counterpart of the synthetic branch of `simlingo_tpu/train/trainer.py:
_train_impl` (:229-321): parameters from a seed (or given), the trainable
partition, AdamW + OneCycle, and `max_steps` steps on one
`synthetic_example` batch of 2 image tiles per sample, printing loss, grad
norm and ms per step. The disk data path, prefetching, checkpoints,
logging, validation and visualisation are not ported (ROADMAP A11, A12,
A16).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from simlingo_tpu_torch.core import gates
from simlingo_tpu_torch.core.config import TrainConfig
from simlingo_tpu_torch.core.device import resolve_device
from simlingo_tpu_torch.data.synthetic import synthetic_example
from simlingo_tpu_torch.models import simlingo
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

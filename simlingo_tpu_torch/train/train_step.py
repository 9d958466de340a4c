"""Training step: forward_loss -> backward -> global-norm clip -> AdamW.

Counterpart of `simlingo_tpu/train/train_step.py`: fp32 master weights for
the trainable leaves, frozen leaves stored in bf16 (`cast_frozen`), a bf16
compute copy made inside the forward (`cast_for_compute`, so autograd hands
back fp32 gradients for the masters), optax-style global-norm clipping and
AdamW with the explicit warmup + cosine OneCycle schedule.

Matching optax (`clip_by_global_norm` then `adamw` with no mask):
  * clipping: g <- g * 0.3 / ||g|| where ||g|| >= 0.3, else unchanged (no
    +1e-6 as in `torch.nn.utils.clip_grad_norm_`);
  * AdamW: eps 1e-8, decoupled weight decay on every trainable leaf;
    `torch.optim.AdamW` with its lr set from the schedule each step computes
    the same update (the tests hold it against `make_train_step`);
  * the schedule is evaluated at the step count before the update.
Under SIMLINGO_CE_IMPL=pallas the fused CE gives the tied head no dW, so
`make_train_step` refuses to build a step whose llm/embed is trainable,
as JAX does (`simlingo_tpu/train/train_step.py:160-179`); pallas_dw
builds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from simlingo_tpu_torch.core import gates
from simlingo_tpu_torch.core.structs import DrivingExample
from simlingo_tpu_torch.models import simlingo
from simlingo_tpu_torch.models.simlingo import SimLingoConfig


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-5
    weight_decay: float = 0.1
    betas: Tuple[float, float] = (0.9, 0.999)
    pct_start: float = 0.05            # OneCycle warmup fraction
    grad_clip: float = 0.3
    total_steps: int = 10_000
    div_factor: float = 25.0           # initial lr = lr / div_factor
    final_div_factor: float = 1e4      # final lr = initial / final_div_factor


def onecycle_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """step -> lr: linear warmup from lr/div_factor to lr over
    round(total_steps * pct_start) steps (at least 1), then cosine decay to
    the final lr over the rest (`train_step.py:40-54`, optax's
    join_schedules of linear_schedule and cosine_decay_schedule)."""
    warmup = max(1, int(round(cfg.total_steps * cfg.pct_start)))
    decay = max(1, cfg.total_steps - warmup)
    init = cfg.lr / cfg.div_factor
    alpha = init / cfg.final_div_factor / cfg.lr

    def schedule(step: int) -> float:
        if step < warmup:
            frac = 1.0 - max(step, 0) / warmup
            return (init - cfg.lr) * frac + cfg.lr
        count = min(step - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay))
        return cfg.lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


# ---------------------------------------------------------------------------
# Parameter trees: paths "vision/layers/0/attn/q/w", as JAX's _path_str
# ---------------------------------------------------------------------------

def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def map_leaves(fn: Callable[[str, torch.Tensor], torch.Tensor],
               tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    return {k: (map_leaves(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
                else fn(f"{prefix}{k}", v)) for k, v in tree.items()}


def production_trainable(path: str) -> bool:
    """The reference's trainable set (simlingo_seed1.yaml): the vision
    tower, the LoRA adapters, the driving adaptors and the waypoint
    encoder; the base LLM is frozen."""
    return not path.startswith("llm/")


def cast_frozen(params, trainable_fn: Callable[[str], bool],
                dtype=torch.bfloat16):
    """Frozen fp32 leaves stored in the compute dtype: they never take an
    update, so an fp32 master would only take memory."""
    return map_leaves(lambda path, x: x if trainable_fn(path)
                      or x.dtype != torch.float32 else x.to(dtype), params)


def cast_for_compute(params, dtype=torch.bfloat16):
    """fp32 leaves -> `dtype` copies, recorded by autograd, so the
    gradients of the fp32 masters come back in fp32."""
    if dtype == torch.float32:
        return params
    return map_leaves(lambda _, x: x.to(dtype) if x.dtype == torch.float32
                      else x, params)


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]                 # the whole tree (masters + frozen)
    trainable: Dict[str, torch.Tensor]     # path -> fp32 master (requires grad)
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_train_state(params, opt_cfg: OptimizerConfig,
                     trainable_fn: Callable[[str], bool] = production_trainable
                     ) -> TrainState:
    """Cast frozen leaves to bf16, make the trainable leaves autograd
    leaves, and build AdamW over them only."""
    params = cast_frozen(params, trainable_fn)
    params = map_leaves(lambda path, x: x.detach().requires_grad_(True)
                        if trainable_fn(path) else x.detach(), params)
    trainable = {p: x for p, x in flatten(params).items() if trainable_fn(p)}
    opt = torch.optim.AdamW(list(trainable.values()), lr=opt_cfg.lr,
                            betas=opt_cfg.betas, eps=1e-8,
                            weight_decay=opt_cfg.weight_decay)
    return TrainState(params=params, trainable=trainable, optimizer=opt)


def make_train_step(model_cfg: SimLingoConfig, opt_cfg: OptimizerConfig,
                    compute_dtype=torch.bfloat16,
                    trainable_fn: Callable[[str], bool] = production_trainable
                    ) -> Callable[[TrainState, DrivingExample, int],
                                  Dict[str, torch.Tensor]]:
    """train_step(state, batch, seed) -> metrics; updates `state` in place.
    Metrics (0-d tensors, not synchronised): loss, each loss average, and
    grad_norm, the global norm of the unclipped gradients. `trainable_fn`
    is the partition the state was built with (JAX's
    `trainable_mask_tree`)."""
    if gates.ce_impl() == "pallas" and trainable_fn("llm/embed/w"):
        raise ValueError(
            "SIMLINGO_CE_IMPL=pallas requires a FROZEN llm/embed (the fused CE "
            "computes no dW for the tied LM head). Freeze the base LLM "
            "(production_trainable), use SIMLINGO_CE_IMPL=pallas_dw (streams "
            "the real dW), or unset SIMLINGO_CE_IMPL.")
    schedule = onecycle_schedule(opt_cfg)

    def train_step(state: TrainState, batch: DrivingExample, seed: int
                   ) -> Dict[str, torch.Tensor]:
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        out, _ = simlingo.forward_loss(cast_for_compute(state.params, compute_dtype),
                                       batch, model_cfg, dropout_seed=seed,
                                       compute_dtype=compute_dtype)
        out.loss.backward()
        grads = []
        for x in state.trainable.values():
            if x.grad is None:           # JAX differentiates to zeros here
                x.grad = torch.zeros_like(x)
            grads.append(x.grad)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = opt_cfg.grad_clip
        torch._foreach_mul_(grads, torch.where(norm < clip, 1.0, clip / norm))
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in out.loss_averages.items()}
        metrics["loss"] = out.loss.detach()
        metrics["grad_norm"] = norm
        return metrics

    return train_step

"""SimLingo-Base training step: forward_loss -> backward -> two parameter
groups, each clipped by its own global norm -> AdamW.

Reference: `train_base.py:49-82`. Every leaf trains. The leaves under
`vision/` form one group at lr x VISION_LR_SCALE (0.1, :53), everything
else (the image newline, the encodings and `language_projection`
included: the mask is the path's prefix, :55-60) the other. JAX chains
two `optax.masked(make_optimizer(...))` (:64-67), and `make_optimizer`
(`simlingo_tpu/train/train_step.py:57-65`) clips inside each, so each
group is clipped by its own global norm and follows its own OneCycle
schedule; AdamW's weight decay applies to every leaf, as
`train/train_step.py` explains. fp32 masters, a bf16 compute copy made
inside the forward (`cast_for_compute`) and fp32 gradients; the loss is
`summarise_losses` of route_loss + speed_wps_loss.

With the ResNet encoder, its running BatchNorm statistics (`bn_state/...`)
are leaves of the "rest" group, as they are leaves of JAX's parameter tree
(`simlingo_tpu/models/simlingo_base.py:83`). The encoder runs with
training=False, so no batch statistic ever enters them; but the
normalisation reads them, so `jax.value_and_grad` differentiates them, and
optax's AdamW moves them by those gradients and decays them by lr x
weight_decay every step. The port does the same: they require grad, and a
leaf whose gradient stays None would take zeros (and the decay) as in JAX.
This is the reference's behaviour, kept, not a fault to fix here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import torch

from simlingo_tpu_torch.data.synthetic import BaseBatch
from simlingo_tpu_torch.models import simlingo_base
from simlingo_tpu_torch.models.simlingo_base import SimLingoBaseConfig
from simlingo_tpu_torch.train import train_step as ts

GROUPS = ("vision", "rest")
VISION_LR_SCALE = 0.1                    # `train_base.py:53`


def group_of(path: str) -> str:
    """`_path_str(p).startswith("vision")` (`train_base.py:55-60`)."""
    return "vision" if path.startswith("vision") else "rest"


@dataclasses.dataclass
class BaseTrainState:
    params: Dict[str, Any]                  # fp32 masters (requires grad)
    groups: Dict[str, List[torch.Tensor]]   # group -> its leaves
    optimizer: torch.optim.Optimizer        # one param group a group, in GROUPS order
    step: int = 0


def init_base_state(params, opt_cfg: ts.OptimizerConfig) -> BaseTrainState:
    params = ts.map_leaves(lambda _, x: x.detach().requires_grad_(True), params)
    groups: Dict[str, List[torch.Tensor]] = {g: [] for g in GROUPS}
    for path, x in ts.flatten(params).items():
        groups[group_of(path)].append(x)
    opt = torch.optim.AdamW([{"params": groups[g]} for g in GROUPS], lr=opt_cfg.lr,
                            betas=opt_cfg.betas, eps=1e-8,
                            weight_decay=opt_cfg.weight_decay)
    return BaseTrainState(params=params, groups=groups, optimizer=opt)


def make_base_train_step(model_cfg: SimLingoBaseConfig, opt_cfg: ts.OptimizerConfig,
                         compute_dtype=torch.bfloat16
                         ) -> Callable[[BaseTrainState, BaseBatch], Dict[str, torch.Tensor]]:
    """train_step(state, batch) -> metrics; updates `state` in place.
    Metrics (0-d tensors, not synchronised): loss, route_loss,
    speed_wps_loss, and each group's unclipped gradient norm
    (grad_norm_vision, grad_norm_rest)."""
    schedules = {"vision": ts.onecycle_schedule(
                     dataclasses.replace(opt_cfg, lr=opt_cfg.lr * VISION_LR_SCALE)),
                 "rest": ts.onecycle_schedule(opt_cfg)}

    def train_step(state: BaseTrainState, batch: BaseBatch) -> Dict[str, torch.Tensor]:
        for name, group in zip(GROUPS, state.optimizer.param_groups):
            group["lr"] = schedules[name](state.step)
        state.optimizer.zero_grad(set_to_none=True)
        out, _ = simlingo_base.forward_loss(ts.cast_for_compute(state.params, compute_dtype),
                                            *batch, model_cfg)
        out.loss.backward()
        metrics = {k: v.detach() for k, v in out.loss_averages.items()}
        metrics["loss"] = out.loss.detach()
        for name, leaves in state.groups.items():
            for x in leaves:
                if x.grad is None:       # unused leaves: JAX differentiates to zeros
                    x.grad = torch.zeros_like(x)
            metrics[f"grad_norm_{name}"] = ts.clip_by_global_norm_(
                [x.grad for x in leaves], opt_cfg.grad_clip)
        state.optimizer.step()
        state.step += 1
        return metrics

    return train_step

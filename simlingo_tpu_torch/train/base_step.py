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

Over dp x fsdp x tp (`init_base_state(mesh=...)`; sp and pp, which cut
the SimLingo LLM, are refused, as JAX's `train_base.py:46-47` refuses sp)
the state holds this rank's shards and the step runs as `train_step.py`'s
sharded step: CLIP and the LLaMA split over the tp group
(`models/clip_vit.py`, `models/qwen2.py`; the ResNet replicated), the
partial gradients of the replicated column biases all-reduced over tp,
and each group clipped by its own norm over every rank, a replicated leaf
counted once (`norm_counted`; the ResNet's `bn_state` stays in the "rest"
group, the same on every tp rank). `parallel/mesh.check_tp` names the tp
the model splits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

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
    mesh: Optional[Any] = None              # more than one rank: shards of each leaf
    layouts: Optional[Dict[str, Any]] = None


def init_base_state(params, opt_cfg: ts.OptimizerConfig, mesh=None) -> BaseTrainState:
    """With a `mesh` of more than one rank, `params` is the full tree and
    the state holds this rank's shards (dp x fsdp x tp)."""
    if mesh is not None and (mesh.shape["sp"] > 1 or mesh.shape["pp"] > 1):
        raise ValueError("SimLingo-Base trains over dp, fsdp and tp; sp and pp cut the "
                         "SimLingo LLM's sequence and layers only")
    params, lays = ts.shard_for_mesh(params, mesh)
    params = ts.map_leaves(lambda _, x: x.detach().requires_grad_(True), params)
    groups: Dict[str, List[torch.Tensor]] = {g: [] for g in GROUPS}
    for path, x in ts.flatten(params).items():
        groups[group_of(path)].append(x)
    opt = torch.optim.AdamW([{"params": groups[g]} for g in GROUPS], lr=opt_cfg.lr,
                            betas=opt_cfg.betas, eps=1e-8,
                            weight_decay=opt_cfg.weight_decay)
    return BaseTrainState(params=params, groups=groups, optimizer=opt,
                          mesh=mesh if lays is not None else None, layouts=lays)


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
        mesh = state.mesh
        if mesh is None:
            out, _ = simlingo_base.forward_loss(
                ts.cast_for_compute(state.params, compute_dtype), *batch, model_cfg)
            out.loss.backward()
        else:
            trainable = ts.flatten(state.params)
            tree, leaves = ts.sharded_compute_tree(state.params, state.layouts, mesh,
                                                   trainable, compute_dtype)
            out, _ = simlingo_base.forward_loss(
                tree, *batch, model_cfg,
                count_reduce=mesh.comm["batch"].all_reduce if mesh.batch_size > 1 else None,
                tp=mesh.tp)
            out.loss.backward()
            del tree
            reduced = ts.reduce_sharded_grads(leaves, state.layouts, mesh)
            del leaves
            for path, x in trainable.items():
                x.grad = reduced[path]
        metrics = {k: v.detach() for k, v in out.loss_averages.items()}
        metrics["loss"] = out.loss.detach()
        metrics = ts.reduce_metrics(metrics, mesh)
        paths = {id(x): p for p, x in ts.flatten(state.params).items()}
        for name, leaves in state.groups.items():
            for x in leaves:
                if x.grad is None:       # unused leaves: JAX differentiates to zeros
                    x.grad = torch.zeros_like(x)
            counted = comm = None
            if mesh is not None:
                counted = [ts.norm_counted(state.layouts[paths[id(x)]], mesh) for x in leaves]
                comm = mesh.comm["world"]
            metrics[f"grad_norm_{name}"] = ts.clip_by_global_norm_(
                [x.grad for x in leaves], opt_cfg.grad_clip, counted, comm)
        state.optimizer.step()
        state.step += 1
        return metrics

    return train_step

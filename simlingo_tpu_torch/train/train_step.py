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

On a dp x fsdp x tp x sp x pp mesh (`parallel/mesh.py`; JAX's XLA
partitioning of the same step) `init_train_state(mesh=...)` keeps this
rank's shards of the masters, the frozen leaves and (through them) the
AdamW moments (a pp stage: of its own layers only), and the step runs
`sharded_compute_tree` (each leaf cast, its fsdp shards and, for the
tp-gathered leaves, its tp shards all-gathered; the trainable ones made
autograd leaves), the rank's forward and backward, `reduce_sharded_grads`
(tp-partial gradients all-reduced over tp, fsdp leaves' reduce-scattered
over fsdp then all-reduced over dp and sp, the rest all-reduced over dp x
fsdp x sp: sums, as each rank's loss is its share of the global batch's
and, under sp, of its positions'; then a leaf replicated over pp summed
over pp, a stage's layer leaves being its own) and the global norm over
every shard, a replicated leaf counted once (`norm_counted`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from simlingo_tpu_torch.core import gates
from simlingo_tpu_torch.parallel import mesh as meshlib
from simlingo_tpu_torch.parallel.mesh import flatten
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


def clip_by_global_norm_(grads, clip: float, counted=None, comm=None) -> torch.Tensor:
    """optax's clip_by_global_norm, in place: g * clip / ||g|| where ||g|| >=
    clip. Returns the unclipped norm. Across ranks (`comm`, the world):
    the squared norms of the `counted` grads summed over every rank."""
    if comm is None or comm.size == 1:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    else:
        mine = [g for g, c in zip(grads, counted) if c]
        sq = (torch.stack(torch._foreach_norm(mine)).square().sum() if mine
              else torch.zeros((), device=grads[0].device))
        norm = comm.all_reduce(sq.float()).sqrt()
    torch._foreach_mul_(grads, torch.where(norm < clip, 1.0, clip / norm))
    return norm


def norm_counted(lay: "meshlib.LeafLayout", mesh: "meshlib.Mesh") -> bool:
    """Whether this rank's shard of the leaf enters the global norm: every
    element once over the world (a leaf replicated on an axis counts at
    index 0 of that axis; dp and sp hold the same reduced grads
    everywhere; a pp stage's layers are its own)."""
    c = mesh.coords
    return (c["dp"] == 0 and c["sp"] == 0 and (lay.fsdp_dim is not None or c["fsdp"] == 0)
            and (lay.tp_dim is not None or c["tp"] == 0)
            and (lay.stage is not None or c["pp"] == 0))


def sharded_compute_tree(params, layouts, mesh, trainable, dtype=torch.bfloat16):
    """(tree the forward reads, {path: its trainable autograd leaf}) from this
    rank's shards: fp32 leaves cast to `dtype`, fsdp shards all-gathered
    (all leaves through one flat buffer a dtype), tp-gathered leaves
    gathered over tp too."""
    flat = flatten(params)
    with torch.no_grad():
        cast = {p: (x.detach().to(dtype) if x.dtype == torch.float32 and dtype != torch.float32
                    else x.detach()) for p, x in flat.items()}
        split = [p for p in cast if layouts[p].fsdp_dim is not None]
        gathered = mesh.comm["fsdp"].all_gather_many([cast[p] for p in split],
                                                     [layouts[p].fsdp_dim for p in split])
        cast.update(zip(split, gathered))
        for p, x in cast.items():
            if layouts[p].tp_use == "gather":
                cast[p] = mesh.comm["tp"].all_gather(x, layouts[p].tp_dim)
    leaves = {}
    for p in trainable:
        cast[p] = leaves[p] = cast[p].detach().requires_grad_(True)
    return meshlib.unflatten(cast), leaves


def reduce_sharded_grads(leaves, layouts, mesh) -> Dict[str, torch.Tensor]:
    """{path: fp32 gradient of this rank's shard} from the compute leaves'
    gradients (module docstring)."""
    grads, partial = {}, []
    for path, y in leaves.items():
        lay = layouts[path]
        g = torch.zeros_like(y, dtype=torch.float32) if y.grad is None else y.grad.float()
        if lay.tp_use == "gather":
            n = g.shape[lay.tp_dim] // mesh.shape["tp"]
            g = g.narrow(lay.tp_dim, mesh.coords["tp"] * n, n).contiguous()
        elif lay.tp_use == "partial":
            partial.append(g)
        grads[path] = g
    mesh.comm["tp"].all_reduce_flat(partial)
    split = [p for p in grads if layouts[p].fsdp_dim is not None]
    grads.update(zip(split, mesh.comm["fsdp"].reduce_scatter_many(
        [grads[p] for p in split], [layouts[p].fsdp_dim for p in split])))
    mesh.comm["dp"].all_reduce_flat([grads[p] for p in split])
    mesh.comm["sp"].all_reduce_flat([grads[p] for p in split])
    mesh.comm["loss"].all_reduce_flat([g for p, g in grads.items() if p not in set(split)])
    mesh.comm["pp"].all_reduce_flat([g for p, g in grads.items() if layouts[p].stage is None])
    return grads


def reduce_metrics(metrics: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Each rank's shares of the loss averages summed over dp x fsdp x sp
    (every pp stage holds the whole batch's)."""
    if mesh is None or mesh.comm["loss"].size == 1:
        return metrics
    keys = list(metrics)
    total = mesh.comm["loss"].all_reduce(torch.stack([metrics[k].float() for k in keys]))
    return dict(zip(keys, total.unbind()))


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]                 # the whole tree (masters + frozen)
    trainable: Dict[str, torch.Tensor]     # path -> fp32 master (requires grad)
    optimizer: torch.optim.Optimizer
    step: int = 0
    mesh: Optional["meshlib.Mesh"] = None  # more than one rank: shards of each leaf
    layouts: Optional[Dict[str, "meshlib.LeafLayout"]] = None   # path -> its layout


def shard_for_mesh(params, mesh):
    """(this rank's tree, layouts) of a full tree; (params, None) where the
    mesh is None or of one rank."""
    if mesh is None or mesh.world == 1:
        return params, None
    lays = meshlib.layouts(flatten(params), mesh)
    return meshlib.shard_params(params, mesh), lays


def init_train_state(params, opt_cfg: OptimizerConfig,
                     trainable_fn: Callable[[str], bool] = production_trainable,
                     mesh=None) -> TrainState:
    """Cast frozen leaves to bf16, make the trainable leaves autograd
    leaves, and build AdamW over them only. With a `mesh` of more than one
    rank `params` is the full tree and the state holds this rank's shards."""
    params, lays = shard_for_mesh(cast_frozen(params, trainable_fn), mesh)
    params = map_leaves(lambda path, x: x.detach().requires_grad_(True)
                        if trainable_fn(path) else x.detach(), params)
    trainable = {p: x for p, x in flatten(params).items() if trainable_fn(p)}
    opt = torch.optim.AdamW(list(trainable.values()), lr=opt_cfg.lr,
                            betas=opt_cfg.betas, eps=1e-8,
                            weight_decay=opt_cfg.weight_decay)
    return TrainState(params=params, trainable=trainable, optimizer=opt,
                      mesh=mesh if lays is not None else None, layouts=lays)


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
        mesh = state.mesh
        if mesh is None:
            tree = cast_for_compute(state.params, compute_dtype)
        else:
            tree, leaves = sharded_compute_tree(state.params, state.layouts, mesh,
                                                state.trainable, compute_dtype)
        out, _ = simlingo.forward_loss(tree, batch, model_cfg, dropout_seed=seed,
                                       compute_dtype=compute_dtype, mesh=mesh)
        out.loss.backward()
        if mesh is None:
            grads = []
            for x in state.trainable.values():
                if x.grad is None:           # JAX differentiates to zeros here
                    x.grad = torch.zeros_like(x)
                grads.append(x.grad)
            norm = clip_by_global_norm_(grads, opt_cfg.grad_clip)
        else:
            del tree
            reduced = reduce_sharded_grads(leaves, state.layouts, mesh)
            del leaves
            for path, x in state.trainable.items():
                x.grad = reduced[path]
            norm = clip_by_global_norm_(
                list(reduced.values()), opt_cfg.grad_clip,
                [norm_counted(state.layouts[p], mesh) for p in reduced], mesh.comm["world"])
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in out.loss_averages.items()}
        metrics["loss"] = out.loss.detach()
        metrics = reduce_metrics(metrics, mesh)
        metrics["grad_norm"] = norm
        return metrics

    return train_step


def make_eval_step(model_cfg: SimLingoConfig, compute_dtype=torch.bfloat16
                   ) -> Callable[[Dict[str, Any], DrivingExample],
                                 Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
    """eval_step(params, batch) -> (metrics, predictions): `forward_loss`
    without gradients or dropout, on the bf16 compute copy
    (`simlingo_tpu/train/train_step.py:make_eval_step` :216); what
    validation and visualisation run. Given a TrainState of a mesh, this
    rank's rows, the metrics of the global batch (collective)."""
    def eval_step(params, batch: DrivingExample):
        mesh = None
        with torch.no_grad():
            if isinstance(params, TrainState):
                mesh = params.mesh
                tree = (cast_for_compute(params.params, compute_dtype) if mesh is None else
                        sharded_compute_tree(params.params, params.layouts, mesh, {},
                                             compute_dtype)[0])
            else:
                tree = cast_for_compute(params, compute_dtype)
            out, preds = simlingo.forward_loss(tree, batch, model_cfg,
                                               compute_dtype=compute_dtype, mesh=mesh)
        metrics = dict(out.loss_averages)
        metrics["loss"] = out.loss
        return reduce_metrics(metrics, mesh), preds

    return eval_step

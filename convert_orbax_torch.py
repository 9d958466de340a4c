#!/usr/bin/env python3
"""Convert a JAX training checkpoint (orbax) into the PyTorch port's format.

    python3 convert_orbax_torch.py outputs/<run>/checkpoints port/<run>/checkpoints
    python3 convert_orbax_torch.py outputs/<run>/checkpoints/step_00002000 DST \\
        --experiment configs/simlingo.yaml [key=value ...]

SRC is a `step_%08d` directory that `train.py` wrote with orbax
(`simlingo_tpu/core/checkpoint.py:save_checkpoint`), or a checkpoint
directory, whose newest finished step is taken. DST receives
`step_%08d/{params.pt, optimizer.pt, meta.json}`, the layout of
`simlingo_tpu_torch/core/checkpoint.py:save_checkpoint`, which
`restore_checkpoint` and `train_torch.py resume=true` (with
`output_dir` / `name` pointing at DST's run) then load as they are.

A migration tool: it runs where `orbax-checkpoint` is installed (it
imports `orbax.checkpoint`, and through it jax) and never on the GPU
machine. It imports nothing of the JAX package.

  * The save is restored without a target tree, as numpy arrays.
  * Parameters go through `core/from_jax.params_from_jax` ([in, out]
    linears transposed, a pipeline's stacked layers unstacked), each leaf
    keeping its dtype (JAX stores frozen leaves in bf16, `cast_frozen`).
  * The optimizer state of `make_optimizer` (`optax.chain(
    clip_by_global_norm, adamw)`; the Adam state over the trainable leaves
    only) becomes torch AdamW's: `mu` -> `exp_avg`, `nu` -> `exp_avg_sq`,
    `count` -> `step`, indexed in the order and with the param group that
    `train_step.init_train_state` builds for the model of the config
    (TrainConfig defaults <- `--experiment` <- overrides, as
    `train_torch.py` composes it: give the config the run will resume
    with). Its model must have the save's leaves and shapes.
  * A save without `opt_state`, or with a chain of another layout, gives
    the parameters and the step only (no `optimizer.pt`, so a resume
    refuses it; evaluation loads it) and says so: no moment is ever
    written as zeros.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np


def find_step_dir(src: str) -> str:
    """SRC itself if it is a step directory, else its newest finished one."""
    src = os.path.abspath(src)
    if os.path.basename(src).startswith("step_"):
        return src
    steps = sorted(d for d in os.listdir(src) if d.startswith("step_") and "tmp" not in d)
    if not steps:
        raise FileNotFoundError(f"no step_* checkpoint under {src}")
    return os.path.join(src, steps[-1])


def _numpy_tree(x):
    """Restored leaves -> numpy arrays; lists stay lists, dicts dicts."""
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_numpy_tree(v) for v in x]
    if x is None:
        return None
    return np.asarray(x)


def restore_orbax(path: str) -> Dict[str, Any]:
    """The saved state as a tree of numpy arrays (no target tree)."""
    import orbax.checkpoint as ocp
    return _numpy_tree(ocp.StandardCheckpointer().restore(os.path.abspath(path)))


def _empty(x) -> bool:
    return x is None or (isinstance(x, dict) and not x)


def adam_state(opt_state) -> Optional[Dict[str, Any]]:
    """{count, mu, nu} of `make_optimizer`'s chain, or None for any other
    layout: [clip_by_global_norm (empty), [scale_by_adam {count, mu, nu},
    add_decayed_weights (empty), scale_by_schedule {count}]]."""
    chain = opt_state                     # orbax restores a tuple as a list
    if not isinstance(chain, list) or len(chain) != 2 or not _empty(chain[0]):
        return None
    if not isinstance(chain[1], list) or len(chain[1]) != 3:
        return None
    adam, decay, sched = chain[1]
    if not (isinstance(adam, dict) and set(adam) == {"count", "mu", "nu"}) \
            or not _empty(decay) or not (isinstance(sched, dict) and set(sched) == {"count"}):
        return None
    if int(adam["count"]) != int(sched["count"]):
        return None
    return adam


def _prune(tree):
    """The tree without its None leaves (the frozen positions of a moment
    tree) and without the dicts left empty."""
    if isinstance(tree, dict):
        out = {k: _prune(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    return tree


def _template(cfg):
    """A train state of cfg's model on the meta device: the port's leaves,
    trainable partition and optimizer order, with no memory."""
    import torch

    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.train import train_step as ts
    params = simlingo.init_params(cfg.model, torch.Generator(), device="meta")
    return ts.init_train_state(params, cfg.optimizer)


def convert(src: str, dst_dir: str, cfg=None) -> Tuple[str, bool]:
    """Convert the save at `src` (see `find_step_dir`) into
    `dst_dir/step_%08d`; returns (that path, whether the AdamW state came
    along). `cfg` is the port's TrainConfig (default: TrainConfig())."""
    import torch

    from simlingo_tpu_torch.core import checkpoint as ckpt
    from simlingo_tpu_torch.core.config import TrainConfig
    from simlingo_tpu_torch.core.from_jax import params_from_jax
    from simlingo_tpu_torch.train.train_step import flatten

    cfg = cfg if cfg is not None else TrainConfig()
    path = find_step_dir(src)
    saved = restore_orbax(path)
    step = int(saved["step"])
    params = flatten(params_from_jax(saved["params"], device="cpu"))
    state = _template(cfg)
    want = flatten(state.params)
    if set(params) != set(want):
        raise ValueError(
            f"{path}: its leaves are not those of the config's model: missing "
            f"{sorted(set(want) - set(params))[:4]}, extra {sorted(set(params) - set(want))[:4]} "
            f"(give the config the run was trained with)")
    for p, x in want.items():
        if tuple(params[p].shape) != tuple(x.shape):
            raise ValueError(f"{path}: {p} is {tuple(params[p].shape)}, the config's model "
                             f"{tuple(x.shape)}")
        if params[p].dtype != x.dtype:
            raise ValueError(f"{path}: {p} is {params[p].dtype}, the port trains it in "
                             f"{x.dtype} (frozen leaves bf16, trainable fp32)")
    host = {"params": {p: params[p].contiguous() for p in want}, "step": step}

    adam = adam_state(saved.get("opt_state"))
    if adam is not None:
        mu = flatten(params_from_jax(_prune(adam["mu"]), device="cpu"))
        nu = flatten(params_from_jax(_prune(adam["nu"]), device="cpu"))
        order = ckpt._param_paths(state)
        if set(mu) != set(order) or set(nu) != set(order):
            raise ValueError(
                f"{path}: the saved AdamW state covers other leaves than the port's "
                f"trainable ones: missing {sorted(set(order) - set(mu))[:4]}, extra "
                f"{sorted(set(mu) - set(order))[:4]}")
        count = float(adam["count"])
        opt = state.optimizer.state_dict()
        opt["state"] = {i: {"step": torch.tensor(count, dtype=torch.float32),
                            "exp_avg": mu[p].float().contiguous(),
                            "exp_avg_sq": nu[p].float().contiguous()}
                        for i, p in enumerate(order)}
        host["optimizer"] = opt
    out = os.path.abspath(os.path.join(dst_dir, f"step_{step:08d}"))
    if os.path.exists(out):
        raise FileExistsError(out)
    os.makedirs(dst_dir, exist_ok=True)
    ckpt._write(out, host)
    return out, adam is not None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="an orbax step_XXXXXXXX directory or a checkpoint directory")
    ap.add_argument("dst", help="the port's checkpoint directory (step_XXXXXXXX goes under it)")
    ap.add_argument("--experiment", default=None,
                    help="configs/<name>.yaml (or a path) over the defaults, as train_torch.py")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides, as train_torch.py")
    args = ap.parse_args(argv)

    from simlingo_tpu_torch.core.config import compose
    out, with_opt = convert(args.src, args.dst, compose(args.experiment, args.overrides))
    if with_opt:
        print(f"wrote {out}: parameters, AdamW state and step")
    else:
        print(f"wrote {out}: parameters and step only -- the save holds no AdamW state of "
              f"make_optimizer's layout (optax.chain(clip_by_global_norm, adamw)), so no "
              f"optimizer.pt: evaluation loads it, a resume refuses it")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Spawned ranks for the port's multi-process tests (imports no JAX).

`spawn(world, case, workdir)` starts `world` child processes, each
`python -m tests.torch_ranks CASE RANK WORLD PORT WORKDIR`, joins them over
gloo on the CPU (`parallel/multihost.initialize` with explicit arguments)
and runs `CASES[case](rank, world, workdir)`. Inputs and results pass
through files in `workdir` (`.npz`, and `torch.save` for results that are
trees). Every spawn joins with a timeout and kills the children's process
groups on the way out, so a hung collective fails one test.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world: int, case: str, workdir: str, timeout: float = 120.0) -> None:
    """Run CASES[case] on `world` ranks; raise with the children's output if
    any fails or they outlast `timeout` seconds."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1" if world > 2 else "2")
    env.pop("JAX_PLATFORMS", None)
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(workdir, f"{case}.rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_ranks", case, str(r), str(world), str(port),
             workdir], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        out = "\n".join(f"--- rank {r} (rc {c}) ---\n" + open(
            os.path.join(workdir, f"{case}.rank{r}.log")).read()[-3000:]
            for r, c in enumerate(codes))
        raise RuntimeError(f"{case} on {world} ranks failed or timed out ({timeout} s): "
                           f"{codes}\n{out}")


# ---------------------------------------------------------------------------
# Shared helpers (numpy only: the test process uses them on JAX's side)
# ---------------------------------------------------------------------------

def save_tree(path: str, tree) -> None:
    """A nested dict of arrays as one .npz of '/'-joined keys."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                a = np.asarray(v)
                flat[f"{prefix}{k}"] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    walk(tree, "")
    np.savez(path, **flat)


def load_tree(path: str):
    out = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *parents, last = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = z[key]
    return out


def thin_answers(loss_mask: np.ndarray, row: int = 1, keep: int = 2) -> np.ndarray:
    """loss_mask with only the first `keep` answer tokens of `row` left, so
    the rows of a batch hold different answer-token counts."""
    m = np.array(loss_mask, copy=True)
    idx = np.flatnonzero(m[row])
    m[row, idx[keep:]] = False
    return m


# ---------------------------------------------------------------------------
# Child side
# ---------------------------------------------------------------------------

def _port_model(spec: dict):
    """The port's tiny SimLingoConfig with the LLM fields of `spec`."""
    import dataclasses
    from simlingo_tpu_torch.models import simlingo as tsim
    base = tsim.SimLingoConfig.tiny()
    return dataclasses.replace(base, llm=dataclasses.replace(base.llm, **spec))


def _mesh_case_dir(workdir):
    with open(os.path.join(workdir, "spec.json")) as f:
        return json.load(f)


def _gathered(state):
    """The state's full parameter tree, flat, on every rank."""
    from simlingo_tpu_torch.parallel import mesh as M
    from simlingo_tpu_torch.train import train_step as ts
    local = ts.map_leaves(lambda _, x: x.detach(), state.params)
    return ts.flatten(M.gather_params(local, state.layouts, state.mesh))


def case_hello(rank, world, workdir):
    """A global sum, is_primary, and put_batch's slices assembling the batch."""
    import torch
    from simlingo_tpu_torch.parallel import mesh as M
    from simlingo_tpu_torch.parallel import multihost
    mesh = M.make_mesh(dp=-1, device="cpu")
    x = torch.full((3,), float(rank + 1))
    mesh.comm["world"].all_reduce(x)
    batch = {"x": torch.arange(4 * world * 2, dtype=torch.float32).view(4 * world, 2),
             "meta": torch.tensor(7.0)}
    local = M.put_batch(batch, mesh)
    assembled = mesh.comm["batch"].all_gather(local["x"].contiguous(), 0)
    multihost.sync_hosts()
    np.savez(os.path.join(workdir, f"hello{rank}.npz"), sum=x.numpy(),
             primary=multihost.is_primary(), local=local["x"].numpy(),
             meta=local["meta"].numpy(), assembled=assembled.numpy(),
             coords=np.array([mesh.coords[a] for a in M.AXES]))


def case_steps(rank, world, workdir):
    """The world-2 step cases of test_torch_parallel_train.py, one mesh
    after another (see each block)."""
    import dataclasses

    import torch
    from simlingo_tpu_torch.core.from_jax import params_from_jax
    from simlingo_tpu_torch.data.synthetic import base_batch, synthetic_example
    from simlingo_tpu_torch.models import simlingo as tsim
    from simlingo_tpu_torch.models import simlingo_base as tbase
    from simlingo_tpu_torch.parallel import mesh as M
    from simlingo_tpu_torch.train import base_step
    from simlingo_tpu_torch.train import train_step as ts

    spec = _mesh_case_dir(workdir)
    out = {}

    def mesh_of(name):
        d, f, t = {"dp2": (2, 1, 1), "fsdp2": (1, 2, 1), "tp2": (1, 1, 2)}[name]
        return M.make_mesh(d, f, t, device="cpu")

    # 1. tp = 2: loss and every gradient of one forward (all leaves trainable)
    cfg = _port_model({})
    params = params_from_jax(load_tree(os.path.join(workdir, "tiny.npz")), device="cpu")
    ex = synthetic_example(cfg, batch=2, seq_len=96, num_patches=1, device="cpu")
    mesh = mesh_of("tp2")
    state = ts.init_train_state(params, ts.OptimizerConfig(), lambda p: True, mesh=mesh)
    tree, leaves = ts.sharded_compute_tree(state.params, state.layouts, mesh, state.trainable,
                                           torch.float32)
    loss, _ = tsim.forward_loss(tree, M.put_batch(ex, mesh), cfg, mesh=mesh)
    loss.loss.backward()
    grads = ts.reduce_sharded_grads(leaves, state.layouts, mesh)
    out["tp2_grad"] = dict(loss=float(loss.loss), grads={
        p: M.gather_leaf(g, state.layouts[p], mesh).clone() for p, g in grads.items()},
        sharded=sorted(p for p, lay in state.layouts.items() if lay.tp_dim is not None))

    # 2. three make_train_step steps (LoRA r=4, dropout 0) at dp2, fsdp2, tp2,
    #    and one dp2 step on a batch whose rows hold different answer counts
    lcfg = _port_model(dict(lora_r=4, lora_alpha=8, lora_dropout=0.0))
    lparams = load_tree(os.path.join(workdir, "lora.npz"))
    lex = synthetic_example(lcfg, batch=2, seq_len=96, num_patches=1, seed=3, device="cpu")
    opt = ts.OptimizerConfig(lr=1e-3, total_steps=10, grad_clip=0.3)
    thin = dataclasses.replace(lex, driving_input=dataclasses.replace(
        lex.driving_input, prompt=dataclasses.replace(
            lex.driving_input.prompt, loss_mask=torch.from_numpy(
                thin_answers(lex.driving_input.prompt.loss_mask.numpy())))))
    for name, batch, n in (("dp2", lex, 3), ("fsdp2", lex, 3), ("tp2", lex, 3),
                           ("thin_dp2", thin, 1)):
        mesh = mesh_of(name.replace("thin_", ""))
        state = ts.init_train_state(params_from_jax(lparams, device="cpu"), opt, mesh=mesh)
        step = ts.make_train_step(lcfg, opt, compute_dtype=torch.float32)
        local = M.put_batch(batch, mesh)
        metrics = [{k: float(v) for k, v in step(state, local, i).items()} for i in range(n)]
        out[name] = dict(metrics=metrics, params=_gathered(state),
                         local_rows=int(local.driving_input.prompt.ids.shape[0]))

    # 3. LoRA dropout 0.1 on: one forward at dp2 and tp2 (masks placed by block)
    dcfg = _port_model(dict(lora_r=4, lora_alpha=8, lora_dropout=0.1))
    for name in ("dp2", "tp2"):
        mesh = mesh_of(name)
        state = ts.init_train_state(params_from_jax(lparams, device="cpu"), opt, mesh=mesh)
        tree, _ = ts.sharded_compute_tree(state.params, state.layouts, mesh, {}, torch.float32)
        with torch.no_grad():
            o, _ = tsim.forward_loss(tree, M.put_batch(lex, mesh), dcfg, dropout_seed=1234,
                                     mesh=mesh)
        out[f"drop_{name}"] = {k: float(v) for k, v in ts.reduce_metrics(
            dict(o.loss_averages, loss=o.loss), mesh).items()}

    # 4. SimLingo-Base: three two-group steps at dp2 and fsdp2
    bcfg = tbase.SimLingoBaseConfig.tiny()
    bparams = load_tree(os.path.join(workdir, "base.npz"))
    bopt = ts.OptimizerConfig(**spec["base_opt"])
    for name in ("dp2", "fsdp2"):
        mesh = mesh_of(name)
        state = base_step.init_base_state(params_from_jax(bparams, device="cpu"), bopt,
                                          mesh=mesh)
        step = base_step.make_base_train_step(bcfg, bopt, torch.float32)
        rng = np.random.RandomState(spec["base_seed"])
        metrics = []
        for _ in range(3):
            batch = M.put_batch(base_batch(rng, spec["base_batch"], bcfg.clip.image_size,
                                           device="cpu"), mesh)
            metrics.append({k: float(v) for k, v in step(state, batch).items()})
        out[f"base_{name}"] = dict(metrics=metrics, params=_gathered(state))

    # 5. the trainer on the synthetic batch (a global batch of 2) at dp2 and tp2
    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.train import trainer
    for name, overrides in (("dp2", ["mesh.dp=2", "data.batch_size=1"]),
                            ("tp2", ["mesh.tp=2", "mesh.dp=1", "data.batch_size=2"])):
        tcfg = compose(spec["trainer"] + overrides)
        tcfg.model = lcfg
        res = trainer.train(tcfg, make_synthetic=True,
                            params=params_from_jax(lparams, device="cpu"), device="cpu")
        out[f"trainer_{name}"] = [{k: r[k] for k in ("loss", "grad_norm")}
                                  for r in res["records"]]

    # 6. the trainer's first step at tp2 in bf16 with LoRA dropout 0.1
    #    (chip_smoke.py's tp control is held to it)
    tcfg = compose(spec["trainer"] + ["mesh.tp=2", "mesh.dp=1", "data.batch_size=2",
                                      "precision=bf16", "max_steps=1"])
    tcfg.model = dcfg
    res = trainer.train(tcfg, make_synthetic=True, params=params_from_jax(lparams, device="cpu"),
                        device="cpu")
    out["trainer_bf16_tp2"] = res["records"][0]["loss"]
    if rank == 0:
        torch.save(out, os.path.join(workdir, "steps.pt"))


def case_mesh222(rank, world, workdir):
    """The tiny model's first step on the (2, 2, 2) mesh of 8 ranks."""
    import torch
    from simlingo_tpu_torch.core.from_jax import params_from_jax
    from simlingo_tpu_torch.data.synthetic import synthetic_example
    from simlingo_tpu_torch.parallel import mesh as M
    from simlingo_tpu_torch.train import train_step as ts
    cfg = _port_model({})
    mesh = M.make_mesh(2, 2, 2, device="cpu")
    opt = ts.OptimizerConfig(lr=1e-3, total_steps=50, grad_clip=1.0)
    state = ts.init_train_state(params_from_jax(load_tree(os.path.join(workdir, "tiny.npz")),
                                                device="cpu"), opt, lambda p: True, mesh=mesh)
    ex = synthetic_example(cfg, batch=8, seq_len=96, num_patches=1, device="cpu")
    m = ts.make_train_step(cfg, opt, compute_dtype=torch.float32)(state, M.put_batch(ex, mesh), 0)
    local = state.params["llm"]["layers"]["0"]["mlp"]["gate"]["w"]
    np.savez(os.path.join(workdir, f"mesh222_{rank}.npz"), loss=float(m["loss"]),
             grad_norm=float(m["grad_norm"]), gate_local=np.array(local.shape),
             coords=np.array([mesh.coords[a] for a in M.AXES]))


def case_disk(rank, world, workdir):
    """The trainer on routes on disk at world 2 (dp 2): each rank's last
    batch; a straight run of 4 steps saving at 2 and 4; a run resumed from
    the step-2 checkpoint to 4."""
    import shutil

    import torch
    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.core.from_jax import params_from_jax
    from simlingo_tpu_torch.parallel import multihost
    from simlingo_tpu_torch.train import trainer

    spec = _mesh_case_dir(workdir)
    model = torch.load(os.path.join(workdir, "disk_model.pt"), weights_only=False)
    params = load_tree(os.path.join(workdir, "disk_params.npz"))
    out = {}

    def run(name, steps, *extra):
        cfg = compose(spec["overrides"] + [f"output_dir={os.path.join(workdir, name)}",
                                           f"max_steps={steps}", *extra])
        cfg.model = model
        return trainer.train(cfg, params=params_from_jax(params, device="cpu"), device="cpu")

    straight = run("straight", 4, "checkpoint_every_n_steps=2", "keep_checkpoints=4")
    b = straight["batch"]
    out["batch"] = {"ids": b.driving_input.prompt.ids.numpy(),
                    "loss_mask": b.driving_input.prompt.loss_mask.numpy(),
                    "pixel_values": b.driving_input.pixel_values.float().numpy(),
                    "waypoints": b.driving_label.waypoints.numpy()}
    out["straight"] = dict(records=straight["records"], params=_gathered(straight["state"]))
    ckpts = os.path.join(workdir, "resumed", "run", "checkpoints")
    if multihost.is_primary():
        os.makedirs(ckpts)
        shutil.copytree(os.path.join(workdir, "straight", "run", "checkpoints",
                                     "step_00000002"), os.path.join(ckpts, "step_00000002"))
    multihost.sync_hosts()
    resumed = run("resumed", 4, "resume=true")
    out["resumed"] = dict(records=resumed["records"], params=_gathered(resumed["state"]))
    torch.save(out, os.path.join(workdir, f"disk{rank}.pt"))


CASES = {"hello": case_hello, "steps": case_steps, "mesh222": case_mesh222,
         "disk": case_disk}


def main(argv) -> int:
    case, rank, world, port, workdir = argv[0], int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    import torch
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    from simlingo_tpu_torch.parallel import multihost
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        CASES[case](rank, world, workdir)
        multihost.sync_hosts()
    finally:
        multihost.shutdown()
    blocked = [m for m in sys.modules if m in ("jax", "simlingo_tpu")
               or m.startswith(("jax.", "simlingo_tpu."))]
    if blocked:
        raise RuntimeError(f"a rank imported {blocked[:3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

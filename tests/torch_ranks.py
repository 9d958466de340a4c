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


class ThreadComm:
    """The sp group's `sendrecv` between threads of one process (rank r's
    mailbox is a queue that only rank r - 1 of the ring fills): drives
    `parallel.sequence._Ring`'s forward and backward on n threads without
    autograd's engine (its device thread would serve the ranks in turn)."""

    def __init__(self, boxes, rank):
        self.boxes, self.rank, self.size = boxes, rank, len(boxes)

    def sendrecv(self, x, dst, src):
        self.boxes[dst].put(x.clone())
        return self.boxes[self.rank].get(timeout=120)


class _Ctx:
    """A stand-in for autograd's ctx: what `_Ring.forward` saves."""

    def save_for_backward(self, *xs):
        self.saved_tensors = xs


def ring_threads(qs, ks, vs, valids, douts, causal, scale=None):
    """`parallel.sequence._Ring` on len(qs) threads, rank i given slab i:
    [(o_i, (dq_i, dk_i, dv_i), lse_i)] in rank order."""
    import queue
    import threading

    import torch
    from simlingo_tpu_torch.parallel import sequence as SQ
    n = len(qs)
    boxes = [queue.Queue() for _ in range(n)]
    out, errors = [None] * n, []
    scale = qs[0].shape[-1] ** -0.5 if scale is None else scale

    def rank(i):
        try:
            ctx, comm = _Ctx(), ThreadComm(boxes, i)
            valid = valids[i].to(torch.uint8).contiguous()
            o = SQ._Ring.forward(ctx, qs[i], ks[i], vs[i], valid, causal, scale, comm)
            ctx.args = (causal, scale, comm)
            out[i] = (o, SQ._Ring.backward(ctx, douts[i])[:3], ctx.saved_tensors[5])
        except BaseException as e:      # noqa: BLE001 -- re-raised below
            errors.append(e)
            for b in boxes:             # unblock the other ranks
                b.put(torch.zeros(0))
    threads = [threading.Thread(target=rank, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors:
        raise errors[0]
    return out


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
             coords=np.array([mesh.coords[a] for a in ("dp", "fsdp", "tp")]))


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

    # 3. LoRA dropout 0.1 on: one forward at dp2 and tp2 (masks placed by
    #    block), and at tp2 with the fused LoRA groups (SIMLINGO_LORA_FUSED=1)
    dcfg = _port_model(dict(lora_r=4, lora_alpha=8, lora_dropout=0.1))
    for name in ("dp2", "tp2", "tp2_fused"):
        mesh = mesh_of(name.replace("_fused", ""))
        state = ts.init_train_state(params_from_jax(lparams, device="cpu"), opt, mesh=mesh)
        tree, _ = ts.sharded_compute_tree(state.params, state.layouts, mesh, {}, torch.float32)
        os.environ["SIMLINGO_LORA_FUSED"] = "1" if name.endswith("_fused") else "0"
        with torch.no_grad():
            o, _ = tsim.forward_loss(tree, M.put_batch(lex, mesh), dcfg, dropout_seed=1234,
                                     mesh=mesh)
        os.environ.pop("SIMLINGO_LORA_FUSED")
        out[f"drop_{name}"] = {k: float(v) for k, v in ts.reduce_metrics(
            dict(o.loss_averages, loss=o.loss), mesh).items()}

    # 4. SimLingo-Base: three two-group steps at dp2, fsdp2 and tp2
    bcfg = tbase.SimLingoBaseConfig.tiny()
    bparams = load_tree(os.path.join(workdir, "base.npz"))
    bopt = ts.OptimizerConfig(**spec["base_opt"])
    for name in ("dp2", "fsdp2", "tp2"):
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
             coords=np.array([mesh.coords[a] for a in ("dp", "fsdp", "tp")]))


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


# ---------------------------------------------------------------------------
# Sequence and pipeline parallelism (tests/test_torch_{sequence,pipeline}_parallel.py)
# ---------------------------------------------------------------------------

def _contexts(mesh, microbatches=0, remat=True):
    """The trainer's sp / pp contexts on `mesh` (a context manager)."""
    import contextlib
    from simlingo_tpu_torch.parallel import pipeline as PL
    from simlingo_tpu_torch.parallel import sequence as SQ
    stack = contextlib.ExitStack()
    stack.enter_context(SQ.sequence_parallel(mesh))
    stack.enter_context(PL.pipeline_parallel(mesh, microbatches=microbatches, remat=remat))
    return stack


def _ring_case(mesh, workdir, causal):
    """The ring of the sp group on ring.npz's whole-sequence inputs: output
    and gradients of sum(out * w), each rank its slab, gathered."""
    import torch
    from simlingo_tpu_torch.parallel import sequence as SQ
    sp = mesh.comm["sp"]
    z = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir, "ring.npz")).items()}
    n = z["q"].shape[1] // sp.size

    def slab(x):
        return x[:, sp.rank * n:(sp.rank + 1) * n].contiguous()
    q, k, v = (slab(z[name]).requires_grad_(True) for name in ("q", "k", "v"))
    out = SQ.ring_attention(q, k, v, slab(z["valid"]), causal, comm=sp)
    (out * slab(z["w"])).sum().backward()
    return {name: sp.all_gather(x.detach(), 1).numpy()
            for name, x in (("o", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}


def _mesh_step(mesh, workdir, batch):
    """One make_train_step step of the tiny model (every leaf trainable) on
    `mesh` with the sp / pp contexts: metrics, the whole tree after it."""
    import torch
    from simlingo_tpu_torch.core.from_jax import params_from_jax
    from simlingo_tpu_torch.data.synthetic import synthetic_example
    from simlingo_tpu_torch.parallel import mesh as M
    from simlingo_tpu_torch.parallel import pipeline as PL
    from simlingo_tpu_torch.parallel import sequence as SQ
    from simlingo_tpu_torch.train import train_step as ts
    cfg = _port_model({})
    opt = ts.OptimizerConfig(lr=1e-3, total_steps=50, grad_clip=1.0)
    ex = synthetic_example(cfg, batch=batch, seq_len=96, num_patches=1, device="cpu")
    with _contexts(mesh):
        state = ts.init_train_state(params_from_jax(load_tree(os.path.join(workdir, "tiny.npz")),
                                                    device="cpu"), opt, lambda p: True, mesh=mesh)
        m = ts.make_train_step(cfg, opt, compute_dtype=torch.float32)(
            state, M.put_batch(ex, mesh), 0)
        traces = (SQ.trace_count(), PL.trace_count())
    held = sorted(ts.flatten(state.params))
    return dict(metrics={k: float(v) for k, v in m.items()}, params=_gathered(state),
                traces=traces, held=held)


def _dropout_losses(mesh, workdir):
    """The LoRA model's forward losses with dropout 0.1 at seed 1234 on
    `mesh` (frozen leaves bf16, as a state holds them)."""
    import torch
    from simlingo_tpu_torch.core.from_jax import params_from_jax
    from simlingo_tpu_torch.data.synthetic import synthetic_example
    from simlingo_tpu_torch.models import simlingo as tsim
    from simlingo_tpu_torch.parallel import mesh as M
    from simlingo_tpu_torch.train import train_step as ts
    cfg = _port_model(dict(lora_r=4, lora_alpha=8, lora_dropout=0.1))
    ex = synthetic_example(cfg, batch=4, seq_len=96, num_patches=1, seed=3, device="cpu")
    with _contexts(mesh):
        state = ts.init_train_state(params_from_jax(load_tree(os.path.join(workdir, "lora.npz")),
                                                    device="cpu"), ts.OptimizerConfig(),
                                    mesh=mesh)
        tree, _ = ts.sharded_compute_tree(state.params, state.layouts, mesh, {}, torch.float32)
        with torch.no_grad():
            o, _ = tsim.forward_loss(tree, M.put_batch(ex, mesh), cfg, dropout_seed=1234,
                                     mesh=mesh)
    return {k: float(v) for k, v in ts.reduce_metrics(dict(o.loss_averages, loss=o.loss),
                                                      mesh).items()}


def _trainer(overrides, workdir, output_dir=""):
    """train_torch's trainer on its synthetic batch (the LoRA model):
    [{loss, grad_norm}] a step, and the state."""
    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.core.from_jax import params_from_jax
    from simlingo_tpu_torch.train import trainer
    spec = _mesh_case_dir(workdir)
    cfg = compose(spec["trainer"] + overrides + [f"output_dir={output_dir}"])
    cfg.model = _port_model(dict(lora_r=4, lora_alpha=8, lora_dropout=0.0))
    res = trainer.train(cfg, make_synthetic=True, device="cpu",
                        params=params_from_jax(load_tree(os.path.join(workdir, "lora.npz")),
                                               device="cpu"))
    return [{k: r[k] for k in ("loss", "grad_norm")} for r in res["records"]], res["state"]


def case_sp2(rank, world, workdir):
    """sp = 2: the ring (both causal modes), the dispatch, one step, the
    dropout losses, the trainer, and the trainer on a sequence that does not
    divide."""
    import torch
    from simlingo_tpu_torch.kernels import flash_attention as FA
    from simlingo_tpu_torch.parallel import mesh as M
    from simlingo_tpu_torch.parallel import sequence as SQ
    mesh = M.make_mesh(1, 1, 1, 2, 1, device="cpu")
    out = {"ring": {c: _ring_case(mesh, workdir, c) for c in (True, False)}}
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 32, 4, 16, generator=g)
    k, v = torch.randn(2, 32, 2, 16, generator=g), torch.randn(2, 32, 2, 16, generator=g)
    d = {}
    with SQ.sequence_parallel(mesh):
        d["active"] = SQ.active_axis() is not None
        with SQ.slab_region():
            FA.attention_autograd(q, k, v, None, True)
            d["routed"] = SQ.trace_count()
            FA.attention_autograd(q[:, -1:], k, v, None, True, q_offset=31)   # a cache: never
            d["with_offset"] = SQ.trace_count()
        FA.attention_autograd(q, k, v, None, True)          # outside the LLM's slab region
        d["outside"] = SQ.trace_count()
        d["slab_of"] = (SQ.slab_of(63), SQ.slab_of(64))
    d["restored"] = SQ.active_axis() is None
    out["dispatch"] = d
    out["step"] = _mesh_step(mesh, workdir, 2)
    out["drop"] = _dropout_losses(mesh, workdir)
    out["trainer"], _ = _trainer(["mesh.sp=2", "data.batch_size=4"], workdir)
    try:
        _trainer(["mesh.sp=2", "data.batch_size=4", "data.max_text_len=97", "max_steps=1"],
                 workdir)
        out["raised"] = None
    except RuntimeError as e:
        out["raised"] = str(e)
    out["restored_after_raise"] = SQ.active_axis() is None
    if rank == 0:
        torch.save(out, os.path.join(workdir, "sp2.pt"))


def case_sp4(rank, world, workdir):
    """4 ranks: the ring at sp = 4 (both causal modes); one step at tp = 2 x
    sp = 2."""
    import torch
    from simlingo_tpu_torch.parallel import mesh as M
    out = {"ring": {c: _ring_case(M.make_mesh(1, 1, 1, 4, 1, device="cpu"), workdir, c)
                    for c in (True, False)}}
    out["tp2_sp2"] = _mesh_step(M.make_mesh(1, 1, 2, 2, 1, device="cpu"), workdir, 2)
    if rank == 0:
        torch.save(out, os.path.join(workdir, "sp4.pt"))


def _pipeline_case(mesh, workdir, name, microbatches, remat):
    """qwen2.forward of pl_<name>.npz's inputs under the pp context: the
    output (every stage's) and, with LoRA, the gradients of mean(out^2)
    for the stage's layer and LoRA leaves, every stage's gathered."""
    import torch
    from simlingo_tpu_torch.core.from_jax import params_from_jax
    from simlingo_tpu_torch.models import qwen2 as Q
    from simlingo_tpu_torch.parallel import mesh as M
    z = load_tree(os.path.join(workdir, f"pl_{name}.npz"))
    cfg = Q.Qwen2Config(**_mesh_case_dir(workdir)[f"pl_{name}"])
    params = params_from_jax(z["params"], device="cpu")
    lora = params_from_jax(z["lora"], device="cpu") if "lora" in z else None
    leaves = {f"layers/{p}": x for p, x in M.flatten(params["layers"]).items()}
    if lora is not None:
        leaves.update({f"lora/{p}": x for p, x in M.flatten(lora["layers"]).items()})
    for x in leaves.values():
        x.requires_grad_(True)
    with _contexts(mesh, microbatches, remat):
        out, _ = Q.forward(params, torch.from_numpy(z["x"]), cfg, torch.from_numpy(z["pos"]),
                           kv_valid=torch.from_numpy(z["valid"]), causal=True,
                           lora_params=lora)
        (out.float() ** 2).mean().backward()
    grads = M.gather_stages({p: x.grad for p, x in leaves.items() if x.grad is not None}, mesh)
    return dict(out=out.detach().numpy(), grads={p: g.numpy() for p, g in grads.items()})


def case_pp2(rank, world, workdir):
    """pp = 2: the pipeline's forward and gradients (microbatches 0 and 4,
    remat on and off, the indivisible batch), one step, the dropout losses,
    the trainer and its final checkpoint."""
    import torch
    from simlingo_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh(1, 1, 1, 1, 2, device="cpu")
    out = {f"pipe_{mb}_{int(remat)}": _pipeline_case(mesh, workdir, "lora", mb, remat)
           for mb, remat in ((0, True), (4, True), (0, False))}
    out["pipe_b3"] = _pipeline_case(mesh, workdir, "b3", 0, True)
    out["step"] = _mesh_step(mesh, workdir, 4)
    out["drop"] = _dropout_losses(mesh, workdir)
    out["trainer"], state = _trainer(["mesh.pp=2", "data.batch_size=4", "name=pp2"], workdir,
                                     os.path.join(workdir, "runs"))
    out["final"] = _gathered(state)
    out["held"] = sorted(M.flatten(state.params))
    if rank == 0:
        torch.save(out, os.path.join(workdir, "pp2.pt"))


def case_pp4(rank, world, workdir):
    """4 ranks: the pipeline at pp = 4 (a layer a stage); one step at fsdp =
    2 x pp = 2 and at sp = 2 x pp = 2."""
    import torch
    from simlingo_tpu_torch.parallel import mesh as M
    out = {"pipe_pp4": _pipeline_case(M.make_mesh(1, 1, 1, 1, 4, device="cpu"), workdir, "lora",
                                      0, True)}
    out["fsdp2_pp2"] = _mesh_step(M.make_mesh(1, 2, 1, 1, 2, device="cpu"), workdir, 4)
    out["sp2_pp2"] = _mesh_step(M.make_mesh(1, 1, 1, 2, 2, device="cpu"), workdir, 4)
    if rank == 0:
        torch.save(out, os.path.join(workdir, "pp4.pt"))


CASES = {"hello": case_hello, "steps": case_steps, "mesh222": case_mesh222,
         "disk": case_disk, "sp2": case_sp2, "sp4": case_sp4, "pp2": case_pp2,
         "pp4": case_pp4}


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

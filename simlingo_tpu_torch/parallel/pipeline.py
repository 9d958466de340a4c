"""Pipeline parallelism: GPipe stages of the LLM's layers over the mesh's pp
group.

Counterpart of `simlingo_tpu/parallel/pipeline.py`. The L decoder layers
are cut into pp contiguous stages of L / pp; a stage's rank holds only its
layers, keyed by their global index (`parallel/mesh.py`, `LeafLayout.stage`),
so `qwen2.layer_seeds` gives every layer the seeds it has in one process.
The batch is cut into M microbatches (`_num_microbatches`: 0 means one a
stage; a batch that M does not divide takes the largest divisor below it,
as JAX's :139-145) that stream through the stages: stage s computes
microbatch m at tick m + s and sends its [mb, T, H] output to stage s + 1,
M + S - 1 ticks in all (the bubble is (S - 1) / M of them, GPipe's cost).
The last stage's outputs go to every stage (`Comm.broadcast`), which JAX's
`psum` (:244) gives, so every stage ends with the final hidden.

The backward (`_Pipeline.backward`) runs the stages in reverse: the last
stage takes the cotangent of its outputs, each stage the one its successor
sends, microbatch M - 1 first; each stage's gradient is autograd's over
its own pass, and the input's cotangent goes to the previous stage. With
`remat` (on by default, as JAX's `enable(remat=True)`) the forward keeps
only each microbatch's stage input and the backward re-runs the stage's
pass, which is what non-reentrant `torch.utils.checkpoint` of the pass
would do (the attention and dropout kernels launch again); without it the
forward keeps every microbatch's graph.

A stage other than the last takes no part in the loss's backward past the
pipeline (`anchor`): the loss head runs on every stage, replicated, but
only the last stage's head is differentiated, so a replicated leaf's
gradient summed over pp is the one-process gradient.

`stack_layer_tree`, `unstack_layer_tree`, `layer_at` and `is_stacked` are
JAX's (:106-136) for JAX's stacked layer layout on numpy trees
(`core/from_jax.py` reads such a tree); the port keeps the dict layout.
Decode (KV-cache) paths never route here; `qwen2.forward` refuses a
stage's tree with a cache, as JAX's assert does.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

# Set by the trainer (or `pipeline_parallel`) before the step runs
_STATE = {"mesh": None, "axis": None, "microbatches": 0, "remat": True, "trace_count": 0}


def enable(mesh, axis: str = "pp", microbatches: int = 0, remat: bool = True) -> None:
    """Route the LLM's cache-free forwards through the pipeline over `axis`;
    a no-op (disable) where the mesh's axis has size 1. microbatches=0: one
    a stage."""
    if mesh.shape.get(axis, 1) > 1:
        _STATE.update(mesh=mesh, axis=axis, microbatches=microbatches, remat=remat,
                      trace_count=0)
    else:
        disable()


def disable() -> None:
    _STATE["mesh"] = _STATE["axis"] = None


def active_axis():
    """(mesh, axis, stages) when pipeline parallelism is enabled, else None."""
    mesh, axis = _STATE["mesh"], _STATE["axis"]
    if mesh is None:
        return None
    return mesh, axis, mesh.shape[axis]


def trace_count() -> int:
    """How many LLM forwards ran through the pipeline since enable()."""
    return _STATE["trace_count"]


@contextlib.contextmanager
def pipeline_parallel(mesh, axis: str = "pp", microbatches: int = 0, remat: bool = True):
    prev = dict(_STATE)
    enable(mesh, axis, microbatches, remat)
    try:
        yield
    finally:
        _STATE.update(prev)


def comm():
    """The pp group's `Comm` of the context (None without one)."""
    st = active_axis()
    return None if st is None else st[0].comm[st[1]]


# ---------------------------------------------------------------------------
# JAX's stacked layer layout (numpy trees)
# ---------------------------------------------------------------------------

def is_stacked(layers: Any) -> bool:
    """True for the stacked layout ({'ln1': ..., 'attn': ...} with leading
    layer dims), False for the dict of layers ({'0': ..., '1': ...})."""
    return isinstance(layers, dict) and "0" not in layers


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_layer_tree(layers: dict) -> Any:
    """{'0': tree, '1': tree, ...} -> one tree of leaves stacked along a new
    leading layer dim."""
    return _map(lambda *xs: np.stack([np.asarray(x) for x in xs], axis=0),
                *(layers[str(i)] for i in range(len(layers))))


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def unstack_layer_tree(stacked: Any) -> dict:
    """Inverse of `stack_layer_tree`."""
    n = np.asarray(_first_leaf(stacked)).shape[0]
    return {str(i): layer_at(stacked, i) for i in range(n)}


def layer_at(stacked: Any, i: int) -> Any:
    """Layer i's slice of a stacked tree."""
    return _map(lambda x: np.asarray(x)[i], stacked)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

def _num_microbatches(batch: int, n_stages: int) -> int:
    m = _STATE["microbatches"] or n_stages
    if batch % m:
        # the largest divisor of batch not above the request (a ragged last
        # microbatch would need another shape)
        m = next(d for d in range(min(m, batch), 0, -1) if batch % d == 0)
    return m


class _Run:
    """What `_Pipeline` needs besides tensors: the stage's pass
    `stage(x_mb, m, params) -> y_mb`, the pp group, M and remat."""

    def __init__(self, stage, comm, microbatches, remat):
        self.stage, self.comm, self.M, self.remat = stage, comm, microbatches, remat


class _Pipeline(torch.autograd.Function):
    """GPipe over the pp group: x [B, ...] -> the last stage's output on
    every stage (module docstring); params are the stage's leaves."""

    @staticmethod
    def forward(ctx, run, x, *params):
        comm, M = run.comm, run.M
        S, s = comm.size, comm.rank
        mb = x.shape[0] // M
        shape = (mb,) + tuple(x.shape[1:])
        ins, graphs, outs = [], [], []
        leaves = None
        if not run.remat:
            leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        for m in range(M):
            x_in = (x[m * mb:(m + 1) * mb] if s == 0
                    else comm.recv(shape, x.dtype, x.device, s - 1))
            if run.remat:
                y = run.stage(x_in, m, params)
                ins.append(x_in)
            else:
                xi = x_in.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = run.stage(xi, m, leaves)
                graphs.append((xi, y))
                y = y.detach()
            if s < S - 1:
                comm.send(y, s + 1)
            else:
                outs.append(y)
        out = torch.cat(outs) if s == S - 1 else torch.empty_like(x)
        comm.broadcast(out, S - 1)
        ctx.run, ctx.ins, ctx.graphs, ctx.leaves = run, ins, graphs, leaves
        ctx.shape = shape
        ctx.save_for_backward(*params)
        return out

    @staticmethod
    def backward(ctx, dout):
        run = ctx.run
        comm, M = run.comm, run.M
        S, s = comm.size, comm.rank
        params = ctx.saved_tensors
        want = [j for j, p in enumerate(params) if ctx.needs_input_grad[2 + j]]
        leaves = ctx.leaves
        if run.remat:
            leaves = [p.detach().requires_grad_(ctx.needs_input_grad[2 + j])
                      for j, p in enumerate(params)]
        sums: list = [None] * len(params)
        dxs: list = [None] * M
        mb = ctx.shape[0]
        for m in reversed(range(M)):
            g = (dout[m * mb:(m + 1) * mb] if s == S - 1
                 else comm.recv(ctx.shape, dout.dtype, dout.device, s + 1))
            if run.remat:
                xi = ctx.ins[m].detach().requires_grad_(True)
                with torch.enable_grad():
                    y = run.stage(xi, m, leaves)
            else:
                xi, y = ctx.graphs[m]
            got = torch.autograd.grad(y, [xi] + [leaves[j] for j in want], g,
                                      allow_unused=True)
            for j, gj in zip(want, got[1:]):
                if gj is not None:
                    gj = gj.float()
                    sums[j] = gj if sums[j] is None else sums[j] + gj
            dx = got[0] if got[0] is not None else torch.zeros(ctx.shape, dtype=dout.dtype,
                                                               device=dout.device)
            if s > 0:
                comm.send(dx, s - 1)
            else:
                dxs[m] = dx
            del y, got
        ctx.ins = ctx.graphs = ctx.leaves = None
        dx = torch.cat(dxs) if s == 0 and ctx.needs_input_grad[1] else None
        return (None, dx, *(None if g is None else g.to(p.dtype) for g, p in zip(sums, params)))


def pipeline_layers(stage: Callable[[torch.Tensor, int, Sequence[torch.Tensor]], torch.Tensor],
                    x: torch.Tensor, params: Sequence[torch.Tensor]) -> torch.Tensor:
    """Run this rank's stage of the LLM's layers as a GPipe pipeline over the
    context's pp group: `stage(x_mb, m, params)` is the stage's pass over
    microbatch m (its rows m * mb to (m + 1) * mb of x). Returns the last
    stage's output [B, ...] on every stage."""
    st = active_axis()
    if st is None:
        raise RuntimeError("pipeline_layers: no pp context")
    pp = st[0].comm[st[1]]
    _STATE["trace_count"] += 1
    run = _Run(stage, pp, _num_microbatches(x.shape[0], pp.size), _STATE["remat"])
    return _Pipeline.apply(run, x, *params)


def microbatches(batch: int) -> int:
    """M for a batch of `batch` rows under the context."""
    st = active_axis()
    return _num_microbatches(batch, st[2]) if st is not None else 1


class _Anchor(torch.autograd.Function):
    """A zero whose backward hands the pipeline a zero cotangent: it joins a
    stage's loss to the pipeline without differentiating the head."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape, ctx.dtype = x.shape, x.dtype
        return torch.zeros((), dtype=torch.float32, device=x.device)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros(ctx.shape, dtype=ctx.dtype, device=g.device)


def is_last_stage() -> bool:
    c = comm()
    return c is None or c.rank == c.size - 1


def anchor(hidden: torch.Tensor) -> Optional[torch.Tensor]:
    """On a stage other than the last, a zero to add to the detached loss
    (so the loss's backward runs the stage's part of the pipeline and no
    part of the head); None elsewhere."""
    if is_last_stage() or not hidden.requires_grad:
        return None
    return _Anchor.apply(hidden)

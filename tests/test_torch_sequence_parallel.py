"""Sequence parallelism (parallel/sequence.py) on gloo ranks of the CPU
against the JAX package's ring and sharded steps (fp32).

Ranks are child processes that import only the port (`tests/torch_ranks.py`),
one spawn a world size; JAX runs here on the 8 virtual CPU devices.

  * the ring, at sp = 2 and 4, causal and not, on JAX's `_rand_qkv` inputs
    (a right-padded batch): output at atol 2e-5 and the gradients of
    sum(out * w) at atol 3e-5 / rtol 1e-4 against JAX's `ring_attention`
    on the same mesh (JAX's own tolerances,
    `tests/test_sequence_parallel.py`);
  * the dispatch (`test_dispatch_routes_and_falls_back`'s cases);
  * one `make_train_step` step of the tiny model, every leaf trainable, at
    sp = 2 and at tp = 2 x sp = 2 against JAX's step on the same mesh under
    `sequence_parallel` (loss and grad norm at rtol 1e-4, every leaf after
    the step at 2e-4);
  * with LoRA dropout 0.1 the sp = 2 losses equal the one-process losses
    (1e-5: each slab draws the one-process mask at its rows); the trainer
    at sp = 2 equals the one-process trainer (2e-4); the trainer raises
    when sp never engages (a sequence that does not divide).
No spawn: the segmented dropout placement, and the chip's `seq_halves`
control on the CPU.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.data.synthetic import synthetic_example as jsynthetic
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.parallel import mesh as jmesh
from simlingo_tpu.parallel import sequence as jsq
from simlingo_tpu.train import train_step as jts
from simlingo_tpu_torch.core.config import compose
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.data.synthetic import synthetic_example
from simlingo_tpu_torch.kernels import dropout as DO
from simlingo_tpu_torch.models import qwen2 as Q
from simlingo_tpu_torch.models import simlingo as tsim
from simlingo_tpu_torch.parallel import mesh as M
from simlingo_tpu_torch.parallel import sequence as SQ
from simlingo_tpu_torch.train import train_step as ts
from tests import torch_ranks as R
from tests.test_sequence_parallel import _rand_qkv
from tests.test_torch_parallel_train import TRAINER, _flat_port, _jax_lora, _jax_tiny, _put
from tests.test_torch_train import _port_cfg

TOL = dict(rtol=2e-4, atol=2e-4)
STEP_OPT = dict(lr=1e-3, total_steps=50, grad_clip=1.0)


def _write_inputs(work):
    _, tiny = _jax_tiny()
    _, lora = _jax_lora()
    R.save_tree(str(work / "tiny.npz"), tiny)
    R.save_tree(str(work / "lora.npz"), lora)
    q, k, v, valid = _rand_qkv(jax.random.PRNGKey(0))
    w = jax.random.normal(jax.random.PRNGKey(2), q.shape, jnp.float32)
    np.savez(work / "ring.npz", q=np.asarray(q), k=np.asarray(k), v=np.asarray(v),
             valid=np.asarray(valid), w=np.asarray(w))
    with open(work / "spec.json", "w") as f:
        json.dump({"trainer": TRAINER}, f)
    return dict(q=q, k=k, v=v, valid=valid, w=w)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("sp_ranks")
    inputs = _write_inputs(work)
    R.spawn(2, "sp2", str(work))
    R.spawn(4, "sp4", str(work))
    return dict(inputs=inputs, sp2=torch.load(work / "sp2.pt", weights_only=False),
                sp4=torch.load(work / "sp4.pt", weights_only=False))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_fwd_and_grads_match_jax_ring(ranks, sp, causal):
    x = ranks["inputs"]
    mesh = jmesh.make_mesh(dp=8 // sp, sp=sp)

    def loss(q, k, v):
        return (jsq.ring_attention(q, k, v, x["valid"], causal=causal, mesh=mesh,
                                   axis="sp") * x["w"]).sum()
    out = jax.jit(lambda q, k, v: jsq.ring_attention(
        q, k, v, x["valid"], causal=causal, mesh=mesh, axis="sp"))(x["q"], x["k"], x["v"])
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x["q"], x["k"], x["v"])
    got = ranks[f"sp{sp}"]["ring"][causal]
    np.testing.assert_allclose(got["o"], np.asarray(out), atol=2e-5, rtol=1e-5)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[name], np.asarray(g), atol=3e-5, rtol=1e-4,
                                   err_msg=name)


def test_dispatch_routes_and_falls_back(ranks):
    """Inside the LLM's slab region a self-attention call routes to the ring;
    a call with q_offset (a KV cache) never does, nor one outside the
    region (the ViT); a sequence that does not divide gets no slab; the
    context is restored on exit."""
    d = ranks["sp2"]["dispatch"]
    assert d["active"] and d["restored"]
    assert (d["routed"], d["with_offset"], d["outside"]) == (1, 1, 1)
    assert d["slab_of"] == (None, (0, 2))                 # rank 0's answer


def _jax_step(mesh, batch, stacked=False, pipelined=True):
    """JAX's make_train_step step of the tiny model on `mesh` (every leaf
    trainable) under its sp / pp contexts (`pipelined=False`: sp's alone):
    metrics and the tree after it in the port's layout."""
    from simlingo_tpu.parallel import pipeline as jpl
    cfg, params = _jax_tiny()
    if stacked:
        params["llm"] = dict(params["llm"], layers=jpl.stack_layer_tree(params["llm"]["layers"]))
    opt = jts.make_optimizer(jts.OptimizerConfig(**STEP_OPT))
    ex = jsynthetic(cfg, batch=batch, seq_len=96, num_patches=1)
    pp = mesh if pipelined else jmesh.make_mesh(dp=len(jax.devices()))
    with jsq.sequence_parallel(mesh), jpl.pipeline_parallel(pp):
        step = jts.make_train_step(cfg, opt, compute_dtype=jnp.float32, donate=False)
        state, m = step(jts.init_train_state(jmesh.shard_params(params, mesh), opt),
                        _put(ex, mesh), jax.random.PRNGKey(1))
        traces = (jsq.trace_count(), jpl.trace_count())
    return ({k: float(v) for k, v in m.items()}, _flat_port(jax.device_get(state["params"])),
            traces)


def check_step(got, want):
    """A port step's metrics and tree against JAX's (`_jax_step`)."""
    metrics, final, traces = want
    assert traces[0] > 0 or traces[1] > 0
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], metrics[k], rtol=1e-4, err_msg=k)
    assert set(got["params"]) == set(final)
    for path, w in final.items():
        np.testing.assert_allclose(got["params"][path].float().numpy(), w, err_msg=path, **TOL)


@pytest.mark.parametrize("mesh", ["sp2", "tp2_sp2"])
def test_step_matches_jax_sharded_step(ranks, mesh):
    if mesh == "sp2":
        got = ranks["sp2"]["step"]
        want = _jax_step(jmesh.make_mesh(1, 1, 1, sp=2, devices=jax.devices()[:2]), 2)
    else:
        got = ranks["sp4"]["tp2_sp2"]
        want = _jax_step(jmesh.make_mesh(1, 1, 2, sp=2, devices=jax.devices()[:4]), 2)
    assert got["traces"][0] > 0                         # the ring ran
    check_step(got, want)


def test_lora_dropout_masks_match_one_process(ranks):
    """LoRA dropout 0.1 at one seed: the sp = 2 losses equal the one-process
    losses, which they do only where each slab drew the one-process mask
    at its rows."""
    cfg, params = _jax_lora()
    pcfg = _port_cfg(dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                                       lora_dropout=0.1)))
    ex = synthetic_example(pcfg, batch=4, seq_len=96, num_patches=1, seed=3, device="cpu")
    tree = ts.cast_frozen(params_from_jax(params, device="cpu"), ts.production_trainable)
    with torch.no_grad():
        want, _ = tsim.forward_loss(tree, ex, pcfg, dropout_seed=1234)
        off, _ = tsim.forward_loss(tree, ex, pcfg)
    assert abs(float(want.loss) - float(off.loss)) > 1e-4
    got = ranks["sp2"]["drop"]
    np.testing.assert_allclose(got["loss"], float(want.loss), rtol=1e-5)
    for k, v in want.loss_averages.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-5, err_msg=k)


def test_trainer_at_sp2_matches_one_process(ranks):
    from simlingo_tpu_torch.train import trainer
    cfg, params = _jax_lora()
    tcfg = compose(TRAINER + ["data.batch_size=4"])
    tcfg.model = _port_cfg(cfg)
    want = trainer.train(tcfg, make_synthetic=True, params=params_from_jax(params, device="cpu"),
                         device="cpu")["records"]
    got = ranks["sp2"]["trainer"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)


def test_trainer_raises_when_sp_never_engages(ranks):
    """sp = 2 on a sequence of 97 + 30 positions: no attention call routes,
    and the trainer fails loudly after its first step, its context cleared."""
    msg = ranks["sp2"]["raised"]
    assert msg is not None and "ring-routed" in msg, msg
    assert ranks["sp2"]["restored_after_raise"]


# ---------------------------------------------------------------------------
# No spawn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_segmented_index_is_the_one_process_index_restricted(n):
    """`global_index` of slab i of n of a [B, T, C] tensor (block (row0, col0,
    width, seg, stride)), at a tp column block too, equals the
    one-process index of those elements; `_drop_block` builds that block."""
    B, T, C = 3, 6 * n, 16
    whole = torch.arange(B * T * C).view(B, T, C)
    seg = T // n
    for i in range(n):
        for col0, cols, tp in ((0, C, None), (8, 8, _HalfTP(1))):
            x = torch.zeros(B, seg, cols)
            block = Q._drop_block(x, (i * seg, seg, T), tp, "row")
            assert block == ((i * seg, col0, C, seg, T) if tp is None
                             else (i * seg, 8, 16, seg, T))
            got = DO.global_index(x.numel(), cols, block).view(B, seg, cols)
            assert torch.equal(got, whole[:, i * seg:(i + 1) * seg, col0:col0 + cols])


class _HalfTP:
    size = 2

    def __init__(self, rank):
        self.rank = rank


def test_slab_masks_are_the_one_process_masks():
    """The dropout of each sp slab (its `_drop_block`) equals the one-process
    dropout of the whole [B, T, H] cut to the slab, and a block whose
    segments abut is the plain row block."""
    x = torch.randn(2, 12, 24, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    seed, rate = 0x243F6A8885A308D3, 0.3
    whole = DO.dropout(x, seed, rate)
    for n in (2, 3, 4):
        s = 12 // n
        for i in range(n):
            block = Q._drop_block(x[:, :s], (i * s, s, 12), None, "column")
            got = DO.dropout(x[:, i * s:(i + 1) * s].contiguous(), seed, rate, block)
            assert torch.equal(got, whole[:, i * s:(i + 1) * s]), (n, i)
    assert DO._normal_block((24, 0, 24, 12, 12), 24) == (24, 0, 24)


def test_chip_smoke_seq_halves_control_is_the_sp2_step():
    """`chip_smoke.py` holds `mesh_sp2` to its `seq_halves` control: the two
    sequence halves of an sp = 2 step in one process (the attention as
    the ring's two chunks merged by lse, each gradient the sum of the
    halves'). In fp32 on the CPU, with LoRA dropout 0.1, its loss and
    every trainable gradient equal the one-process forward's at 1e-5."""
    import chip_smoke
    cfg, params = _jax_lora()
    model = _port_cfg(dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                                        lora_dropout=0.1)))
    ex = synthetic_example(model, batch=2, seq_len=96, num_patches=1, device="cpu")
    states = [ts.init_train_state(params_from_jax(params, device="cpu"), ts.OptimizerConfig())
              for _ in range(2)]
    outs = chip_smoke.seq_halves_losses(torch, states[0].params, ex, 5, model,
                                        dtype=torch.float32)
    got = outs[0].loss + outs[1].loss
    got.backward()
    want, _ = tsim.forward_loss(ts.cast_for_compute(states[1].params, torch.float32), ex,
                                model, dropout_seed=5)
    want.loss.backward()
    np.testing.assert_allclose(float(got.detach()), float(want.loss.detach()), rtol=1e-5)
    grads = {p: (states[0].trainable[p].grad, x.grad) for p, x in states[1].trainable.items()}
    top = max(float(w.abs().max()) for _, w in grads.values() if w is not None)
    for p, (g, w) in grads.items():
        assert (g is None) == (w is None), p
        if w is not None:       # each leaf against its own scale, or 1e-3 of the largest
            scale = max(float(w.abs().max()), 1e-3 * top)       # (the ViT's k bias: noise)
            np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale, atol=1e-5,
                                       err_msg=p)


def test_slab_count_check_and_isolation():
    """`slab_of` gives no slab without a context, and `ring_attention`
    refuses without a group; the module imports no JAX."""
    assert SQ.active_axis() is None and SQ.slab_of(64) is None
    with pytest.raises(RuntimeError, match="no sp context"):
        SQ.ring_attention(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8),
                          torch.zeros(1, 4, 2, 8))
    with pytest.raises(ValueError, match="self-attention"):
        SQ.ring_attention(torch.zeros(1, 4, 2, 8), torch.zeros(1, 5, 2, 8),
                          torch.zeros(1, 5, 2, 8), comm=M.Comm())

"""Pipeline parallelism (parallel/pipeline.py) on gloo ranks of the CPU
against the JAX package's pipeline and sharded steps (fp32).

Ranks are child processes that import only the port (`tests/torch_ranks.py`),
one spawn a world size; JAX runs here on the 8 virtual CPU devices.

  * the pipelined Qwen2 forward (4 layers with LoRA, a ragged batch of 4,
    JAX's `tests/test_pipeline_parallel.py` inputs) at pp = 2 with 0 (one
    a stage) and 4 microbatches and at pp = 4, and the indivisible batch of
    3 (one microbatch), against JAX's `pipeline_layers` on the same mesh
    (1e-5, its tolerance); the gradients of mean(out^2) for every layer and
    LoRA leaf, stage remat on and off, against JAX's (2e-4 / 2e-5);
  * one `make_train_step` step of the tiny model, every leaf trainable, at
    pp = 2, fsdp = 2 x pp = 2 and sp = 2 x pp = 2 against JAX's step on the
    same mesh (its stacked layer layout; loss and grad norm at rtol 1e-4,
    every leaf after the step at 2e-4), each stage holding only its layers
    (JAX cannot nest its ring in its pipeline: at sp = 2 x pp = 2 its step
    runs the ring over the pp-sharded layers in sequence);
  * with LoRA dropout 0.1 the pp = 2 losses equal the one-process losses
    (1e-5: a microbatch's masks are placed at its rows); the trainer at pp =
    2 equals the one-process trainer (2e-4); its final checkpoint, gathered
    from both stages, restores at world 1 bit for bit.
No spawn: JAX's stacked tree through `params_from_jax`, the microbatch
count, and a stage's tree refusing the KV cache.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.models import qwen2 as jq
from simlingo_tpu.parallel import mesh as jmesh
from simlingo_tpu.parallel import pipeline as jpl
from simlingo_tpu_torch.core.config import compose
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.data.synthetic import synthetic_example
from simlingo_tpu_torch.models import qwen2 as Q
from simlingo_tpu_torch.models import simlingo as tsim
from simlingo_tpu_torch.parallel import mesh as M
from simlingo_tpu_torch.parallel import pipeline as PL
from simlingo_tpu_torch.train import train_step as ts
from tests import torch_ranks as R
from tests.test_pipeline_parallel import _setup, _stacked
from tests.test_torch_parallel_train import TRAINER, _flat_port, _jax_lora, _jax_tiny
from tests.test_torch_sequence_parallel import _jax_step, check_step
from tests.test_torch_train import _port_cfg

TOL = dict(rtol=2e-4, atol=2e-4)


def _write_pipeline_inputs(work, name, **kw):
    cfg, params, lora, x, pos, valid = _setup(**kw)
    tree = {"params": params, "x": np.asarray(x), "pos": np.asarray(pos),
            "valid": np.asarray(valid)}
    if lora is not None:
        tree["lora"] = lora
    R.save_tree(str(work / f"pl_{name}.npz"), tree)
    return dataclasses.asdict(cfg), (cfg, params, lora, x, pos, valid)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("pp_ranks")
    _, tiny = _jax_tiny()
    _, lora = _jax_lora()
    R.save_tree(str(work / "tiny.npz"), tiny)
    R.save_tree(str(work / "lora.npz"), lora)
    spec_lora, inputs = _write_pipeline_inputs(work, "lora", lora=True)
    spec_b3, inputs_b3 = _write_pipeline_inputs(work, "b3", B=3, lora=False)
    with open(work / "spec.json", "w") as f:
        json.dump({"trainer": TRAINER, "pl_lora": spec_lora, "pl_b3": spec_b3}, f)
    R.spawn(2, "pp2", str(work))
    R.spawn(4, "pp4", str(work))
    return dict(work=work, inputs=inputs, inputs_b3=inputs_b3,
                pp2=torch.load(work / "pp2.pt", weights_only=False),
                pp4=torch.load(work / "pp4.pt", weights_only=False))


def _jax_pipeline(inputs, pp, microbatches=0, remat=True, grads=True):
    """JAX's pipelined forward (and gradients of mean(out^2) for the layer
    and LoRA leaves, in the port's flat layout) on the stacked tree."""
    cfg, params, lora, x, pos, valid = inputs
    sp_, slo = _stacked(params, lora)
    mesh = jmesh.make_mesh(dp=8 // pp, pp=pp)

    def fwd(p, lo):
        out, _ = jq.forward(p, x, cfg, pos, kv_valid=valid, causal=True, lora_params=lo)
        return out

    with jpl.pipeline_parallel(mesh, microbatches=microbatches, remat=remat):
        out = jax.jit(fwd)(sp_, slo)
        g = (jax.jit(jax.grad(lambda p, lo: (fwd(p, lo).astype(jnp.float32) ** 2).mean(),
                              argnums=(0, 1)))(sp_, slo) if grads else None)
        assert jpl.trace_count() > 0
    if g is None:
        return np.asarray(out), None
    flat = {f"layers/{p}": x.float().numpy() for p, x in M.flatten(params_from_jax(
        jax.device_get(g[0]), device="cpu")["layers"]).items()}
    if lora is not None:
        flat.update({f"lora/{p}": x.float().numpy() for p, x in M.flatten(params_from_jax(
            jax.device_get(g[1]), device="cpu")["layers"]).items()})
    return np.asarray(out), flat


@pytest.mark.parametrize("case,pp,microbatches", [("pipe_0_1", 2, 0), ("pipe_4_1", 2, 4),
                                                  ("pipe_pp4", 4, 0)])
def test_pipeline_forward_matches_jax_pipeline(ranks, case, pp, microbatches):
    want, _ = _jax_pipeline(ranks["inputs"], pp, microbatches, grads=False)
    world = "pp4" if pp == 4 else "pp2"
    np.testing.assert_allclose(ranks[world][case]["out"], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("remat", [True, False])
def test_pipeline_grads_match_jax_pipeline(ranks, remat):
    _, want = _jax_pipeline(ranks["inputs"], 2, 0, remat)
    got = ranks["pp2"][f"pipe_0_{int(remat)}"]["grads"]
    assert set(got) == set(want)             # both stages' layers, gathered
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=2e-4, atol=2e-5, err_msg=path)


def test_pipeline_indivisible_batch_falls_back(ranks):
    """B = 3 at pp = 2: 2 microbatches do not divide it, so 1 (JAX's rule)."""
    want, _ = _jax_pipeline(ranks["inputs_b3"], 2, 0, grads=False)
    np.testing.assert_allclose(ranks["pp2"]["pipe_b3"]["out"], want, rtol=1e-5, atol=1e-5)
    with PL.pipeline_parallel(M.Mesh(1, 1, 1, pp=2)):
        assert [PL._num_microbatches(b, 2) for b in (3, 4, 6)] == [1, 2, 2]
    with PL.pipeline_parallel(M.Mesh(1, 1, 1, pp=2), microbatches=4):
        assert [PL._num_microbatches(b, 2) for b in (3, 4, 6, 8)] == [3, 4, 3, 4]
    assert PL.active_axis() is None


@pytest.mark.parametrize("mesh", ["pp2", "fsdp2_pp2", "sp2_pp2"])
def test_step_matches_jax_sharded_step(ranks, mesh):
    shape = {"pp2": (1, 1, 1, 1, 2), "fsdp2_pp2": (1, 2, 1, 1, 2),
             "sp2_pp2": (1, 1, 1, 2, 2)}[mesh]
    got = ranks["pp2"]["step"] if mesh == "pp2" else ranks["pp4"][mesh]
    n = int(np.prod(shape))
    # JAX cannot run its ring inside its pipeline (the ring's shard_map
    # refuses the pipeline's context mesh, whose pp is manual): its sp2 x pp2
    # step runs the ring over the pp-sharded stacked layers in sequence
    want = _jax_step(jmesh.make_mesh(*shape, devices=jax.devices()[:n]), 4, stacked=True,
                     pipelined=mesh != "sp2_pp2")
    assert got["traces"][1] > 0                         # the pipeline ran
    if shape[3] > 1:
        assert got["traces"][0] > 0                     # and the ring
    # rank 0 (stage 0) holds only the first half of the layers
    assert any(p.startswith("llm/layers/0/") for p in got["held"])
    assert not any(p.startswith("llm/layers/1/") for p in got["held"])
    check_step(got, want)


def test_lora_dropout_masks_match_one_process(ranks):
    """LoRA dropout 0.1 at one seed: the pp = 2 losses (2 microbatches)
    equal the one-process losses, which they do only where each
    microbatch drew the one-process mask at its rows."""
    cfg, params = _jax_lora()
    pcfg = _port_cfg(dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                                       lora_dropout=0.1)))
    ex = synthetic_example(pcfg, batch=4, seq_len=96, num_patches=1, seed=3, device="cpu")
    tree = ts.cast_frozen(params_from_jax(params, device="cpu"), ts.production_trainable)
    with torch.no_grad():
        want, _ = tsim.forward_loss(tree, ex, pcfg, dropout_seed=1234)
        off, _ = tsim.forward_loss(tree, ex, pcfg)
    assert abs(float(want.loss) - float(off.loss)) > 1e-4
    got = ranks["pp2"]["drop"]
    np.testing.assert_allclose(got["loss"], float(want.loss), rtol=1e-5)
    for k, v in want.loss_averages.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-5, err_msg=k)


def test_trainer_at_pp2_matches_one_process(ranks):
    from simlingo_tpu_torch.train import trainer
    cfg, params = _jax_lora()
    tcfg = compose(TRAINER + ["data.batch_size=4"])
    tcfg.model = _port_cfg(cfg)
    want = trainer.train(tcfg, make_synthetic=True, params=params_from_jax(params, device="cpu"),
                         device="cpu")["records"]
    got = ranks["pp2"]["trainer"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)


def test_pp2_checkpoint_restores_at_world_1(ranks):
    """The pp = 2 trainer's final checkpoint (each stage's layers and AdamW
    moments gathered onto the primary, numbered as one process numbers
    them) restores into a one-process state bit for bit, and a step runs
    from it."""
    from simlingo_tpu_torch.core import checkpoint as ckpt
    cfg, params = _jax_lora()
    model = _port_cfg(cfg)
    tcfg = compose(TRAINER + ["data.batch_size=4"])
    path = ckpt.latest_checkpoint(str(ranks["work"] / "runs" / "pp2" / "checkpoints"))
    state = ts.init_train_state(params_from_jax(params, device="cpu"), tcfg.optimizer)
    ckpt.restore_checkpoint(path, state)
    assert state.step == 2
    final = ranks["pp2"]["final"]
    leaves = ts.flatten(state.params)
    assert set(leaves) == set(final)
    for p, x in leaves.items():
        assert torch.equal(x.detach(), final[p]), p
    opt = torch.load(f"{path}/optimizer.pt", weights_only=True)
    assert len(opt["state"]) == len(state.trainable)
    assert opt["param_groups"][0]["params"] == list(range(len(state.trainable)))
    held = set(ranks["pp2"]["held"])
    assert "lora/layers/0/q/a" in held and "lora/layers/1/q/a" not in held
    ex = synthetic_example(model, batch=4, seq_len=96, num_patches=1, device="cpu")
    m = ts.make_train_step(model, tcfg.optimizer, torch.float32)(state, ex, 0)
    assert np.isfinite(float(m["loss"])) and state.step == 3


# ---------------------------------------------------------------------------
# No spawn
# ---------------------------------------------------------------------------

def test_params_from_jax_takes_the_stacked_layout():
    """JAX's stacked tree (`stack_layer_tree` of the LLM's and LoRA's
    layers, its pp layout) gives the port the tree its dict layout gives."""
    import jax.tree_util as jtu
    from simlingo_tpu.models import simlingo as jsim
    cfg = dataclasses.replace(jsim.SimLingoConfig.tiny(), llm=dataclasses.replace(
        jsim.SimLingoConfig.tiny().llm, lora_r=4, lora_alpha=8))
    params = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    stacked = dict(params, llm=dict(params["llm"], layers=jpl.stack_layer_tree(
        params["llm"]["layers"])), lora=dict(params["lora"], layers=jpl.stack_layer_tree(
            params["lora"]["layers"])))
    assert PL.is_stacked(jtu.tree_map(np.asarray, stacked["llm"]["layers"]))
    want = ts.flatten(params_from_jax(params, device="cpu"))
    got = ts.flatten(params_from_jax(jtu.tree_map(np.asarray, stacked), device="cpu"))
    assert set(got) == set(want)
    for p, x in want.items():
        assert torch.equal(got[p], x), p
    back = PL.unstack_layer_tree(PL.stack_layer_tree(jtu.tree_map(
        np.asarray, params["llm"]["layers"])))
    assert set(back) == set(params["llm"]["layers"])
    np.testing.assert_array_equal(PL.layer_at(PL.stack_layer_tree(jtu.tree_map(
        np.asarray, params["llm"]["layers"])), 1)["attn"]["q"]["w"],
        np.asarray(params["llm"]["layers"]["1"]["attn"]["q"]["w"]))


def test_stage_layouts_and_refusals():
    """A stage owns the contiguous block of layers (and their LoRA factors)
    that the pp shard of JAX's stacked layer dim names, every other leaf
    replicated over pp; a stage's tree refuses the KV cache and a forward
    outside the pipeline; pp must divide the layers."""
    cfg = tsim.SimLingoConfig.tiny()
    sizes = {"dp": 1, "fsdp": 2, "tp": 1, "sp": 1, "pp": 2}
    lay = M.leaf_layout("llm/layers/1/attn/q/w", (64, 64), sizes, num_layers=2)
    assert lay.stage == 1 and lay.fsdp_dim == 1          # fsdp as the unstacked rule
    assert M.leaf_layout("lora/layers/0/q/a", (4, 64), sizes, 2).stage == 0
    assert M.leaf_layout("vision/layers/1/attn/q/w", (64, 64), sizes, 2).stage is None
    assert M.leaf_layout("llm/embed/w", (512, 64), sizes, 2).stage is None
    with pytest.raises(ValueError, match="divide"):
        M.check_pp(cfg, 3)                                # tiny: 2 layers
    M.check_pp(tsim.SimLingoConfig(), 2)
    params = Q.init_params(torch.Generator().manual_seed(0), cfg.llm)
    stage = dict(params, layers={"1": params["layers"]["1"]})
    x = torch.zeros(1, 4, cfg.llm.hidden_size)
    pos = torch.arange(4)[None]
    cache = Q.init_cache(cfg.llm, 1, 8, dtype=torch.float32)
    for kw in ({"cache": cache}, {}):
        with pytest.raises(ValueError, match="pipeline stage"):
            Q.forward(stage, x, cfg.llm, pos, **kw)


def test_mesh_orders_ranks_as_jax():
    """rank = (((dp * F + fsdp) * T + tp) * SP + sp) * PP + pp, pp innermost
    (JAX `make_mesh`'s device order), and the groups an axis each."""
    dev = np.arange(16).reshape(2, 1, 2, 2, 2)
    for r in range(16):
        m = M.Mesh(2, 1, 2, rank=r, sp=2, pp=2)
        assert dev[tuple(m.coords[a] for a in M.AXES)] == r
        for axis in M.AXES:
            idx = [m.coords[a] if a != axis else slice(None) for a in M.AXES]
            assert m.comm[axis].ranks == sorted(dev[tuple(idx)].reshape(-1).tolist())
        assert len(m.comm["loss"].ranks) == 4 and r in m.comm["loss"].ranks   # dp x sp
    assert M.Mesh(2, 1, 2, sp=2, pp=2).world == 16

"""The port's multi-GPU training (parallel/mesh.py) on gloo ranks of the
CPU against the JAX package's sharded and unsharded steps (fp32).

Ranks are child processes that import only the port (`tests/torch_ranks.py`);
JAX runs here on the 8 virtual CPU devices. Four spawns:

  * 8 ranks, (2, 2, 2): the tiny model's first step against JAX's step on
    the same mesh (`tests/test_train_step.py:32-58`): loss rtol 1e-4;
  * 2 ranks, one mesh after another: tp = 2 loss and every gradient
    against JAX's tp = 2 mesh (`tests/test_train_step.py:61-100`: loss rtol
    1e-5, gradients normalised by their max at atol 2e-5); three
    `make_train_step` steps (LoRA r=4, dropout 0) at dp = 2, fsdp = 2 and
    tp = 2 against JAX's three unsharded steps (2e-4); a dp = 2 step on a
    batch whose rows hold different answer-token counts (2e-4: the loss
    averages divide by the global count); with LoRA dropout 0.1, the dp = 2
    and tp = 2 losses equal the one-process loss of the same seed (1e-5:
    the masks are the one-process masks restricted to each block); and
    SimLingo-Base's two-group step at dp = 2 and fsdp = 2 against JAX's
    `train_base.py` step on the same mesh (2e-4) and at tp = 2 against
    JAX's step on a tp = 2 mesh; with SIMLINGO_LORA_FUSED=1 the tp = 2
    dropout loss equals the one-process fused loss; the trainer's bf16
    tp = 2 step against `chip_smoke.py`'s tp control;
  * 2 ranks, the trainer on routes on disk: each rank's collated batch
    equals JAX's per-process batch at process_count 2 (`trainer.py:334-346`)
    exactly; a run resumed at world 2 from a world-2 checkpoint equals the
    straight run bit for bit; that checkpoint restores at world 1 to the
    gathered state exactly.
sp and pp accepted, the refusals (an indivisible tp, SimLingo-Base's sp and
pp; its tp = 2 accepted) and the dropout blocks need no spawn (sp and pp themselves:
tests/test_torch_{sequence,pipeline}_parallel.py).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.data.synthetic import synthetic_example as jsynthetic
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.models import simlingo_base as jbase
from simlingo_tpu.parallel import mesh as jmesh
from simlingo_tpu.train import train_step as jts
from simlingo_tpu_torch.core.config import compose
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.data.synthetic import base_batch
from simlingo_tpu_torch.data.synthetic import synthetic_example
from simlingo_tpu_torch.kernels import dropout as DO
from simlingo_tpu_torch.models import simlingo as tsim
from simlingo_tpu_torch.parallel import mesh as M
from simlingo_tpu_torch.train import train_step as ts
from tests import torch_ranks as R
from tests.test_torch_base import _jax_loss, _optax_chain
from tests.test_torch_train import _port_cfg

TOL = dict(rtol=2e-4, atol=2e-4)
BASE_OPT = dict(lr=1e-3, total_steps=10, grad_clip=1.0)
LORA_OPT = dict(lr=1e-3, total_steps=10, grad_clip=0.3)
# the trainer on its synthetic batch, 2 steps (a global batch of 2)
TRAINER = ["max_steps=2", "data.max_text_len=96", "precision=fp32", "seed=7", "output_dir=",
           "optimizer.lr=1e-3", "optimizer.total_steps=10"]


def _jax_tiny():
    cfg = jsim.SimLingoConfig.tiny()
    return cfg, jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)


def _jax_lora():
    base = jsim.SimLingoConfig.tiny()
    cfg = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, lora_r=4, lora_alpha=8, lora_dropout=0.0))
    params = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    params["lora"] = jax.tree_util.tree_map(lambda x: x + 0.02, params["lora"])
    return cfg, params


def _put(ex, mesh):
    return jax.tree_util.tree_map(jax.device_put, ex, jmesh.batch_shardings(ex, mesh))


def _flat_port(tree):
    """{path: fp32 array} of a JAX tree in the port's layout."""
    return {p: x.float().numpy()
            for p, x in ts.flatten(params_from_jax(tree, device="cpu")).items()}


# ---------------------------------------------------------------------------
# 8 ranks: the (2, 2, 2) mesh
# ---------------------------------------------------------------------------

def test_mesh_222_first_step_matches_jax_sharded_step(tmp_path):
    cfg, params = _jax_tiny()
    R.save_tree(str(tmp_path / "tiny.npz"), params)
    R.spawn(8, "mesh222", str(tmp_path))
    opt = jts.make_optimizer(jts.OptimizerConfig(lr=1e-3, total_steps=50, grad_clip=1.0))
    ex = jsynthetic(cfg, batch=8, seq_len=96, num_patches=1)
    mesh = jmesh.make_mesh(dp=2, fsdp=2, tp=2)
    step = jts.make_train_step(cfg, opt, compute_dtype=jnp.float32, donate=False)
    _, jm = step(jts.init_train_state(jmesh.shard_params(params, mesh), opt), _put(ex, mesh),
                 jax.random.PRNGKey(1))
    ranks = [np.load(tmp_path / f"mesh222_{r}.npz") for r in range(8)]
    for z in ranks:            # every rank holds the global batch's metrics
        np.testing.assert_allclose(float(z["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(z["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert tuple(z["gate_local"]) == (64, 32)        # [128, 64] over tp x fsdp
    assert sorted(tuple(z["coords"]) for z in ranks) == [
        (d, f, t) for d in range(2) for f in range(2) for t in range(2)]


# ---------------------------------------------------------------------------
# 2 ranks: the step cases, one spawn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_steps")
    tiny_cfg, tiny = _jax_tiny()
    lora_cfg, lora = _jax_lora()
    bcfg = jbase.SimLingoBaseConfig.tiny()
    bparams = jax.jit(jbase.init_params, static_argnums=1)(jax.random.PRNGKey(0), bcfg)
    R.save_tree(str(work / "tiny.npz"), tiny)
    R.save_tree(str(work / "lora.npz"), lora)
    R.save_tree(str(work / "base.npz"), bparams)
    with open(work / "spec.json", "w") as f:
        json.dump({"base_opt": BASE_OPT, "base_seed": 3, "base_batch": 4,
                   "trainer": TRAINER}, f)
    R.spawn(2, "steps", str(work))
    got = torch.load(work / "steps.pt", weights_only=False)
    return dict(got=got, tiny=(tiny_cfg, tiny), lora=(lora_cfg, lora), base=(bcfg, bparams))


def test_tp2_loss_and_grads_match_jax_tp2(steps):
    cfg, params = steps["tiny"]
    ex = jsynthetic(cfg, batch=2, seq_len=96, num_patches=1)

    def loss_fn(p, b):
        out, _ = jsim.forward_loss(p, b, cfg, compute_dtype=jnp.float32)
        return out.loss

    mesh = jmesh.make_mesh(dp=1, fsdp=1, tp=2, devices=jax.devices()[:2])
    l2, g2 = jax.jit(jax.value_and_grad(loss_fn))(jmesh.shard_params(params, mesh),
                                                  _put(ex, mesh))
    got = steps["got"]["tp2_grad"]
    np.testing.assert_allclose(got["loss"], float(l2), rtol=1e-5)
    want = _flat_port(jax.device_get(g2))
    assert set(got["grads"]) == set(want)
    # split heads and widths in both towers, the vocabulary stored split
    assert {"llm/layers/0/attn/q/w", "llm/layers/0/mlp/down/w", "vision/layers/0/mlp/fc1/w",
            "vision/projector/fc2/w", "llm/embed/w"} <= set(got["sharded"])
    for path, w in want.items():
        g = got["grads"][path].numpy()
        if path.startswith("vision/") and path.endswith("attn/k/b"):
            # identically zero (softmax ignores a shift shared by all keys):
            # both sides hold rounding noise of ~1e-10
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-8, path
            continue
        denom = max(np.abs(w).max(), 1e-8)
        np.testing.assert_allclose(g / denom, w / denom, atol=2e-5,
                                   err_msg=path)


@pytest.fixture(scope="module")
def jax_lora_steps(steps):
    """JAX's unsharded steps of the LoRA model (one jitted step for both
    batches): three on the synthetic batch, one on the thinned batch."""
    cfg, params = steps["lora"]
    mask = jts.trainable_mask(params, jts.production_trainable)
    opt = jts.make_optimizer(jts.OptimizerConfig(**LORA_OPT))
    step = jts.make_train_step(cfg, opt, compute_dtype=jnp.float32, donate=False,
                               trainable_mask_tree=mask)
    ex = jsynthetic(cfg, batch=2, seq_len=96, num_patches=1, seed=3)
    pr = ex.driving_input.prompt
    thinned = R.thin_answers(np.asarray(pr.loss_mask))
    thin = dataclasses.replace(ex, driving_input=dataclasses.replace(
        ex.driving_input, prompt=dataclasses.replace(pr, loss_mask=jnp.asarray(thinned))))

    def run(batch, n):
        state = jts.init_train_state(params, opt, trainable_mask_tree=mask)
        metrics = []
        for i in range(n):
            state, m = step(state, batch, jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, _flat_port(jax.device_get(state["params"]))
    return {"three": run(ex, 3), "thin": run(thin, 1), "thin_counts": thinned.sum(1)}


def _check_steps(got, want_metrics, want_params, keys=("loss", "grad_norm", "language_loss",
                                                       "route_loss", "speed_wps_loss")):
    assert len(got["metrics"]) == len(want_metrics)
    for m, jm in zip(got["metrics"], want_metrics):
        for k in keys:
            np.testing.assert_allclose(m[k], jm[k], err_msg=k, **TOL)
    assert set(got["params"]) == set(want_params)
    for path, w in want_params.items():
        np.testing.assert_allclose(got["params"][path].float().numpy(), w, err_msg=path,
                                   **TOL)


@pytest.mark.parametrize("mesh", ["dp2", "fsdp2", "tp2"])
def test_three_steps_track_jax(steps, jax_lora_steps, mesh):
    metrics, final = jax_lora_steps["three"]
    assert metrics[0]["grad_norm"] > LORA_OPT["grad_clip"]     # the clip is active
    got = steps["got"][mesh]
    assert got["local_rows"] == (2 if mesh == "tp2" else 1)
    _check_steps(got, metrics, final)


def test_dp2_rows_with_different_answer_counts(steps, jax_lora_steps):
    """Rank 0 holds a row of 8 answer tokens, rank 1 one of 2: the
    language loss is the global batch's mean only if each rank divides by
    the global count."""
    counts = jax_lora_steps["thin_counts"]
    assert counts[1] == 2 and counts[0] >= 8, counts
    metrics, final = jax_lora_steps["thin"]
    _check_steps(steps["got"]["thin_dp2"], metrics, final)


def test_lora_dropout_masks_match_one_process(steps, monkeypatch):
    """LoRA dropout 0.1 at one seed: the dp = 2 and tp = 2 losses equal the
    one-process loss, which they do only where every rank drew the
    one-process mask of its block (rows for dp; rows and, at o / down,
    columns for tp); with SIMLINGO_LORA_FUSED=1 the tp = 2 loss equals
    the one-process fused loss (a group's mask is the same on both
    ranks)."""
    monkeypatch.delenv("SIMLINGO_LORA_FUSED", raising=False)
    cfg, params = steps["lora"]
    pcfg = _port_cfg(dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                                       lora_dropout=0.1)))
    ex = synthetic_example(pcfg, batch=2, seq_len=96, num_patches=1, seed=3, device="cpu")
    tree = ts.cast_frozen(params_from_jax(params, device="cpu"), ts.production_trainable)
    with torch.no_grad():        # the frozen LLM in bf16, as the ranks' state holds it
        want, _ = tsim.forward_loss(tree, ex, pcfg, dropout_seed=1234)
        off, _ = tsim.forward_loss(tree, ex, pcfg)
    assert abs(float(want.loss) - float(off.loss)) > 1e-4      # dropout changed the loss
    for mesh in ("dp2", "tp2"):
        got = steps["got"][f"drop_{mesh}"]
        np.testing.assert_allclose(got["loss"], float(want.loss), rtol=1e-5, err_msg=mesh)
        for k, v in want.loss_averages.items():
            np.testing.assert_allclose(got[k], float(v), rtol=1e-5, err_msg=f"{mesh} {k}")
    # the fused LoRA groups: one mask a group, the same on both tp ranks
    os.environ["SIMLINGO_LORA_FUSED"] = "1"
    try:
        with torch.no_grad():
            fused, _ = tsim.forward_loss(tree, ex, pcfg, dropout_seed=1234)
    finally:
        os.environ.pop("SIMLINGO_LORA_FUSED")
    assert abs(float(fused.loss) - float(want.loss)) > 1e-6      # the masks changed
    got = steps["got"]["drop_tp2_fused"]
    np.testing.assert_allclose(got["loss"], float(fused.loss), rtol=1e-5)
    for k, v in fused.loss_averages.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-5, err_msg=f"tp2 fused {k}")


@pytest.mark.parametrize("mesh", ["dp2", "tp2"])
def test_trainer_on_the_synthetic_batch_matches_one_process(steps, mesh):
    """train_torch's trainer at world 2 (each rank its rows of the global
    synthetic batch, or the whole batch under tp) against the same trainer
    in one process on the same global batch: losses and grad norms at
    2e-4."""
    from simlingo_tpu_torch.train import trainer
    cfg, params = steps["lora"]
    tcfg = compose(TRAINER + ["data.batch_size=2"])
    tcfg.model = _port_cfg(cfg)
    want = trainer.train(tcfg, make_synthetic=True, params=params_from_jax(params, device="cpu"),
                         device="cpu")["records"]
    got = steps["got"][f"trainer_{mesh}"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)


def test_chip_smoke_tp_control_reproduces_the_tp2_forward(steps):
    """chip_smoke.py holds `mesh_tp2` to its `tp` control (`control_step`:
    one process, each tp-split product cut in two as tp = 2 cuts it), with
    the control's own difference from the one-process trainer as the
    tolerance's unit. Here, in bf16 with LoRA dropout 0.1, the world-2
    trainer's step-1 loss lies within a tenth of that difference of the
    control's, and the difference is not zero: the control reproduces the
    rounding that tp's split sums change."""
    import chip_smoke
    from simlingo_tpu_torch.train import trainer
    _, params = steps["lora"]
    model = R._port_model(dict(lora_r=4, lora_alpha=8, lora_dropout=0.1))
    tcfg = compose(TRAINER + ["data.batch_size=2", "precision=bf16", "max_steps=1"])
    tcfg.model = model
    plain = trainer.train(tcfg, make_synthetic=True, params=params_from_jax(params, device="cpu"),
                          device="cpu")["records"][0]["loss"]
    state = ts.init_train_state(params_from_jax(params, device="cpu"), tcfg.optimizer)
    ex = synthetic_example(model, batch=2, seq_len=96, num_patches=2, device="cpu")
    control = chip_smoke.control_step(torch, state, ex, trainer.step_seed(tcfg.seed, 0), model,
                                      tcfg.optimizer, "tp")["loss"]
    got = steps["got"]["trainer_bf16_tp2"]
    assert abs(control - plain) > 0
    assert abs(got - control) <= 0.1 * abs(control - plain), (got, control, plain)


@pytest.mark.parametrize("mesh", ["dp2", "fsdp2", "tp2"])
def test_base_two_group_steps_match_jax_on_the_same_mesh(steps, mesh):
    cfg, params = steps["base"]
    opt = _optax_chain(params, jts.OptimizerConfig(**BASE_OPT))
    loss_fn = _jax_loss(cfg)
    jm_ = jmesh.make_mesh(dp=2 if mesh == "dp2" else 1, fsdp=2 if mesh == "fsdp2" else 1,
                          tp=2 if mesh == "tp2" else 1, devices=jax.devices()[:2])
    p = jmesh.shard_params(params, jm_)
    o = opt.init(p)

    @jax.jit
    def jstep(p, o, *batch):
        (loss, avg), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, *batch)
        updates, o = opt.update(grads, o, p)
        return jax.tree_util.tree_map(jnp.add, p, updates), o, dict(avg, loss=loss)

    rng = np.random.RandomState(3)
    want = []
    bs = jmesh.batch_sharding(jm_)
    for _ in range(3):
        batch = [jax.device_put(x.numpy(), bs)
                 for x in base_batch(rng, 4, cfg.clip.image_size, device="cpu")]
        p, o, m = jstep(p, o, *batch)
        want.append({k: float(v) for k, v in m.items()})
    got = steps["got"][f"base_{mesh}"]
    _check_steps(got, want, _flat_port(jax.device_get(p)),
                 keys=("loss", "route_loss", "speed_wps_loss"))


def test_chip_smoke_base_tp_control_reproduces_the_base_tp2_steps(steps):
    """chip_smoke.py holds `base_tp2` to its `tp` control
    (`base_tp_control`: SimLingo-Base's one-process step with CLIP and the
    LLaMA on their tp code paths, each split product cut in two). Here, in
    fp32 on the tiny config, the control's three steps equal the world-2
    tp = 2 steps at 1e-5, and they ran the cut products."""
    import chip_smoke
    from simlingo_tpu_torch.data.synthetic import base_batch
    from simlingo_tpu_torch.models import layers as L
    from simlingo_tpu_torch.models.simlingo_base import SimLingoBaseConfig
    from simlingo_tpu_torch.train import base_step
    _, params = steps["base"]
    cfg, opt = SimLingoBaseConfig.tiny(), ts.OptimizerConfig(**BASE_OPT)
    state = base_step.init_base_state(params_from_jax(params, device="cpu"), opt)
    step = base_step.make_base_train_step(cfg, opt, torch.float32)
    rng = np.random.RandomState(3)
    roles = []
    with chip_smoke.base_tp_control(torch):
        split = L.linear
        L.linear = lambda p, x: roles.append(p.get("tp2_role")) or split(p, x)
        try:
            metrics = [{k: float(v) for k, v in step(state, base_batch(
                rng, 4, cfg.clip.image_size, device="cpu")).items()} for _ in range(3)]
        finally:
            L.linear = split
    assert {"row", "column"} <= set(roles)
    got = steps["got"]["base_tp2"]
    for m, g in zip(metrics, got["metrics"]):
        for k in ("loss", "grad_norm_vision", "grad_norm_rest"):
            np.testing.assert_allclose(m[k], g[k], rtol=1e-5, err_msg=k)
    for path, x in ts.flatten(state.params).items():
        np.testing.assert_allclose(x.detach().numpy(), got["params"][path].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=path)


# ---------------------------------------------------------------------------
# 2 ranks: the trainer on disk, its batches and checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    from tests import test_torch_trainer_disk as D
    from tests import torch_routes as TR
    root = str(tmp_path_factory.mktemp("mesh_routes"))
    tdir = TR.write_dataset(root)
    work = tmp_path_factory.mktemp("mesh_disk")
    jm = D._tiny_jax_cfg(lora_dropout=0.1)
    overrides = TR.data_overrides(root, tdir, batch_size=1) + [
        f"seed={D.SEED}", "log_every_n_steps=1", "val_max_batches=1", "precision=fp32",
        "visualise_every_n_steps=0", "data.base.img_augmentation=false", "name=run"]
    with open(work / "spec.json", "w") as f:
        json.dump({"overrides": overrides}, f)
    params = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(D.SEED), jm)
    R.save_tree(str(work / "disk_params.npz"), params)
    torch.save(_port_cfg(jm), work / "disk_model.pt")
    R.spawn(2, "disk", str(work))
    ranks = [torch.load(work / f"disk{r}.pt", weights_only=False) for r in range(2)]
    return dict(work=work, ranks=ranks, jm=jm, overrides=overrides, root=root)


def test_disk_batches_equal_jax_per_process_batches(disk):
    """`trainer.py:334-346` at process_count 2: each rank's last batch
    (step index 3) equals JAX's process batch."""
    from simlingo_tpu.core.config import compose as jcompose
    from simlingo_tpu.data.collate import CollateConfig, collate
    from simlingo_tpu.data.sampler import WeightedBucketSampler
    from simlingo_tpu.data.tokenizer import SimLingoTokenizer
    from simlingo_tpu.train.trainer import build_buckets
    cfg = jcompose(overrides=disk["overrides"] + ["output_dir=", "max_steps=4"])
    buckets, datasets = build_buckets(cfg)
    sampler = WeightedBucketSampler(buckets, seed=cfg.seed)
    tok = SimLingoTokenizer(cfg.tokenizer_path)
    ccfg = CollateConfig(max_text_len=cfg.data.max_text_len,
                         num_image_tokens=disk["jm"].vit.tokens_per_patch_image
                         * cfg.data.base.max_num_grid)
    B, pc, step = cfg.data.batch_size, 2, 3
    assert B == 1
    for pi, got in enumerate(disk["ranks"]):
        picks = sampler.batch_at(step, B * pc)[pi * B:(pi + 1) * B]
        rng = np.random.RandomState(cfg.seed * 7919 + step * pc + pi)
        ex = collate([datasets[b].get(i, rng) for b, i in picks], tok, ccfg)
        b = got["batch"]
        np.testing.assert_array_equal(b["ids"], np.asarray(ex.driving_input.prompt.ids))
        np.testing.assert_array_equal(b["loss_mask"],
                                      np.asarray(ex.driving_input.prompt.loss_mask))
        np.testing.assert_array_equal(b["pixel_values"],
                                      np.asarray(ex.driving_input.pixel_values, np.float32))
        np.testing.assert_array_equal(b["waypoints"], np.asarray(ex.driving_label.waypoints))
    picks = sampler.batch_at(step, B * pc)
    assert picks[0] != picks[1]                     # the ranks hold different samples


def test_disk_resume_at_world_2_is_bit_identical(disk):
    for got in disk["ranks"]:
        s, r = got["straight"], got["resumed"]
        assert [x["step"] for x in r["records"]] == [3, 4]
        for a, b in zip(s["records"][2:], r["records"]):
            for k in ("loss", "language_loss", "route_loss", "grad_norm"):
                assert a[k] == b[k], (a["step"], k)
        assert set(s["params"]) == set(r["params"])
        for p, x in s["params"].items():
            assert torch.equal(r["params"][p], x), p
    a, b = (g["straight"]["params"] for g in disk["ranks"])
    assert all(torch.equal(a[p], b[p]) for p in a)                # every rank the same tree


def test_disk_checkpoint_of_world_2_restores_at_world_1(disk):
    """The final checkpoint of the world-2 run, gathered onto its primary,
    holds the run's whole tree exactly and restores into a one-process
    state (parameters and AdamW moments) from which a step runs."""
    from simlingo_tpu_torch.core import checkpoint as ckpt
    path = str(disk["work"] / "straight" / "run" / "checkpoints" / "step_00000004")
    cfg = compose(disk["overrides"] + ["output_dir=", "max_steps=1"])
    model = _port_cfg(disk["jm"])
    params = params_from_jax(R.load_tree(str(disk["work"] / "disk_params.npz")), device="cpu")
    state = ts.init_train_state(params, cfg.optimizer)
    ckpt.restore_checkpoint(path, state)
    assert state.step == 4
    want = disk["ranks"][0]["straight"]["params"]
    for p, x in ts.flatten(state.params).items():
        assert torch.equal(x.detach(), want[p]), p
    opt = torch.load(os.path.join(path, "optimizer.pt"), weights_only=True)
    assert len(opt["state"]) == len(state.trainable)
    for i, x in enumerate(state.trainable.values()):
        assert torch.equal(state.optimizer.state[x]["exp_avg"], opt["state"][i]["exp_avg"])
        assert state.optimizer.state[x]["exp_avg"].shape == x.shape
    ex = synthetic_example(model, batch=2, seq_len=cfg.data.max_text_len, num_patches=1,
                           device="cpu")
    m = ts.make_train_step(model, cfg.optimizer, torch.float32)(state, ex, 0)
    assert np.isfinite(float(m["loss"])) and state.step == 5


# ---------------------------------------------------------------------------
# No spawn: refusals and dropout blocks
# ---------------------------------------------------------------------------

def test_sp_pp_and_indivisible_tp_are_refused():
    """sp and pp compose with dp, fsdp and tp and are accepted (sizes below
    1 are not); an indivisible tp is refused, and so are SimLingo-Base's sp
    and pp. SimLingo-Base takes tp = 2 on its tiny config and refuses a tp
    that does not divide its heads (CLIP 4, the `debug` LLaMA 2)."""
    for good in (["mesh.sp=2"], ["mesh.pp=2"], ["mesh.sp=2", "mesh.pp=2"],
                 ["mesh.dp=2", "mesh.fsdp=2", "mesh.tp=2", "mesh.sp=2", "mesh.pp=2",
                  "mesh.pp_microbatches=4"]):
        compose(good).mesh.check_supported()
    for bad in ("mesh.sp=0", "mesh.pp=0", "mesh.pp_microbatches=-1"):
        with pytest.raises(ValueError, match=">= 1"):
            compose([bad]).mesh.check_supported()
    cfg = tsim.SimLingoConfig.tiny()        # 4 ViT heads, 2 kv heads
    M.check_tp(cfg, 2)
    for tp in (3, 4):
        with pytest.raises(ValueError, match="whole heads"):
            M.check_tp(cfg, tp)
    M.check_tp(tsim.SimLingoConfig(), 2)    # Qwen2-0.5B: 2 kv heads
    with pytest.raises(ValueError, match="whole heads"):
        M.check_tp(tsim.SimLingoConfig(), 4)
    with pytest.raises(ValueError, match="processes"):
        M.make_mesh(2, 1, 1, device="cpu")  # one process here
    from simlingo_tpu_torch.models.simlingo_base import SimLingoBaseConfig
    from simlingo_tpu_torch.train import base_step
    base_step.init_base_state({}, ts.OptimizerConfig(), mesh=M.Mesh(1, 1, 2))
    tiny = SimLingoBaseConfig.tiny()
    M.check_tp(tiny, 2)
    with pytest.raises(ValueError, match="whole heads") as err:
        M.check_tp(tiny, 4)
    assert "the LLaMA's heads" in str(err.value) and "CLIP" not in str(err.value)
    M.check_tp(SimLingoBaseConfig(), 2)
    for mesh in (M.Mesh(1, 1, 1, sp=2), M.Mesh(1, 1, 1, pp=2)):
        with pytest.raises(ValueError, match="sp and pp"):
            base_step.init_base_state({}, ts.OptimizerConfig(), mesh=mesh)


@pytest.mark.parametrize("shape", [(6, 10, 16), (4, 7, 24)])
def test_dropout_blocks_are_the_one_process_mask_restricted(shape):
    """The plain dropout of each dp / tp block equals the one-process
    dropout of the whole tensor cut to that block."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    seed, rate = 0x243F6A8885A308D3, 0.3
    whole = DO.dropout(x, seed, rate)
    B, T, C = shape
    for dp in (1, 2):
        for tp in (1, 2, 4):
            if B % dp or C % tp:
                continue
            b, c = B // dp, C // tp
            for i in range(dp):
                for j in range(tp):
                    blk = x[i * b:(i + 1) * b, :, j * c:(j + 1) * c].contiguous()
                    got = DO.dropout(blk, seed, rate, (i * b * T, j * c, C))
                    assert torch.equal(got, whole[i * b:(i + 1) * b, :, j * c:(j + 1) * c]), \
                        (dp, tp, i, j)
    assert torch.equal(DO.dropout(x, seed, rate, (0, 0, C)), whole)   # the identity block


def test_dropout_kernel_placement_of_the_blocks():
    """What the kernel is handed for each block (its own test on the card:
    tests/test_torch_cuda.py): the identity is no block (the one-process
    kernel), a flat base for rows
    alone, (row0, col0, width) strided for columns, and a refusal where a
    thread's 8 elements would not start at a multiple of 4 of the index."""
    assert DO._kernel_placement(896, (3 * 798, 0, 896)) == (3 * 798 * 896, 0, 0, 0, 0, 0)
    assert DO._kernel_placement(448, (0, 448, 896)) == (0, 448, 896, 1, 0, 0)
    assert DO._kernel_placement(2432, (40, 2432, 4864)) == (40, 2432, 4864, 1, 0, 0)
    # sp = 2's second slab (segments of 399 rows, 798 apart): mode 2
    assert DO._kernel_placement(896, (399, 0, 896, 399, 798)) == (399, 0, 896, 2, 399, 798)
    assert DO._normal_block((0, 0, 896), 896) is None
    for cols, block, msg in ((12, (0, 12, 24), "cols % 8"), (10, (1, 0, 10), "% 4"),
                             (448, (0, 512, 896), "does not hold")):
        with pytest.raises(ValueError, match=msg):
            DO._kernel_placement(cols, block)

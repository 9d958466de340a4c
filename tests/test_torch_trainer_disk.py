"""The port's trainer on routes on disk, against the JAX trainer (CPU, fp32).

Both trainers run `train(cfg)` on the same routes (`tests/torch_routes.py`)
from the same JAX-initialised tiny model (LoRA r=4, dropout 0): 3 steps of
batch 2 drawn by the sampler from the driving and dreamer buckets, then one
validation batch. The logged per-step losses and the validation losses
agree at 2e-4. A port run stopped at step 2 and resumed to step 4 (LoRA
dropout 0.1, async periodic saves) equals one run of 4 steps exactly:
losses, parameters and AdamW moments. `compose("configs/simlingo.yaml")`
equals JAX's on every field both configs have.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from simlingo_tpu.core.config import compose as jcompose
from simlingo_tpu.core.config import to_dict as jto_dict
from simlingo_tpu.data.tokenizer import SimLingoTokenizer
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from simlingo_tpu.models.vit import ViTConfig as JViTConfig
from simlingo_tpu.train import trainer as JT
from simlingo_tpu_torch.core.config import compose, to_dict
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.train import train_step as tts
from simlingo_tpu_torch.train import trainer as TT
from tests import torch_routes as R
from tests.test_torch_train import _port_cfg

SEED = 5


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_trainer"))
    return root, R.write_dataset(root)


def _tiny_jax_cfg(lora_dropout=0.0):
    tok = SimLingoTokenizer()
    return jsim.SimLingoConfig(
        vit=JViTConfig(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                       image_size=56, patch_size=14, projector_out=32),
        llm=JQwen2Config(vocab_size=tok.tk.vocab_size + 8, hidden_size=32, num_layers=1,
                         num_heads=2, num_kv_heads=1, head_dim=16, intermediate_size=64,
                         lora_r=4, lora_alpha=8, lora_dropout=lora_dropout),
        img_context_token_id=tok.img_context_id, remat_vision=False, remat_llm=False,
        max_answer_len=64)


def _overrides(root, tdir, out, *extra):
    return R.data_overrides(root, tdir, batch_size=2) + [
        f"seed={SEED}", "log_every_n_steps=1", "val_max_batches=1", "precision=fp32",
        "checkpoint_every_n_steps=0", "visualise_every_n_steps=0",
        "data.base.img_augmentation=false", f"output_dir={out}", "name=run", *extra]


def _logged(out):
    with open(os.path.join(out, "run", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_matches_jax(dataset, tmp_path, monkeypatch):
    root, tdir = dataset
    jm = _tiny_jax_cfg()
    # both trainers start from one jitted init; JAX's orbax save is not
    # under test here (importing orbax alone takes ~30 s on the CPU)
    init = jax.jit(jsim.init_params, static_argnums=1)
    monkeypatch.setattr(JT.simlingo, "init_params", init)
    monkeypatch.setattr(JT.ckpt, "save_checkpoint", lambda *a, **k: None)
    jcfg = jcompose(overrides=_overrides(root, tdir, str(tmp_path / "jax"), "max_steps=3"))
    object.__setattr__(jcfg, "model", jm)
    ref = JT.train(jcfg)
    tcfg = compose(_overrides(root, tdir, str(tmp_path / "torch"), "max_steps=3"))
    tcfg.model = _port_cfg(jm)
    params = params_from_jax(init(jax.random.PRNGKey(SEED), jm), device="cpu")
    got = TT.train(tcfg, params=params, device="cpu")
    assert got["total_steps"] == ref["total_steps"] == 3
    jlog, tlog = _logged(str(tmp_path / "jax")), _logged(str(tmp_path / "torch"))
    jsteps = [m for m in jlog if "loss" in m]
    tsteps = [m for m in tlog if "loss" in m]
    assert [m["step"] for m in tsteps] == [m["step"] for m in jsteps] == [1, 2, 3]
    keys = ("loss", "language_loss", "route_loss", "speed_wps_loss", "grad_norm")
    for j, t in zip(jsteps, tsteps):
        for k in keys:
            np.testing.assert_allclose(t[k], j[k], rtol=2e-4, atol=2e-4, err_msg=k)
    jval = [m for m in jlog if "val_loss" in m]
    tval = [m for m in tlog if "val_loss" in m]
    assert len(jval) == len(tval) == 1
    for k in ("val_loss", "val_language_loss", "val_route_loss", "val_speed_wps_loss"):
        np.testing.assert_allclose(tval[0][k], jval[0][k], rtol=2e-4, atol=2e-4, err_msg=k)
    np.testing.assert_allclose(got["metrics"]["val_loss"], ref["metrics"]["val_loss"],
                               rtol=2e-4, atol=2e-4)
    assert os.path.isdir(os.path.join(tmp_path, "torch", "run", "checkpoints", "step_00000003"))


def test_resume_equals_straight_run(dataset, tmp_path):
    root, tdir = dataset
    model = _port_cfg(_tiny_jax_cfg(lora_dropout=0.1))

    def run(out, steps, *extra):
        cfg = compose(_overrides(root, tdir, str(out), f"max_steps={steps}",
                                 "val_every_n_epochs=0", *extra))
        cfg.model = model
        return TT.train(cfg, device="cpu")

    straight = run(tmp_path / "straight", 4, "checkpoint_every_n_steps=1", "keep_checkpoints=2")
    assert sorted(os.listdir(tmp_path / "straight" / "run" / "checkpoints")) == [
        "step_00000003", "step_00000004"]
    first = run(tmp_path / "resumed", 2)
    resumed = run(tmp_path / "resumed", 4, "resume=true")
    assert [r["step"] for r in resumed["records"]] == [3, 4]
    for a, b in zip(straight["records"][2:], resumed["records"]):
        for k in ("loss", "language_loss", "route_loss", "speed_wps_loss", "grad_norm"):
            assert a[k] == b[k], (a["step"], k, a[k], b[k])
    assert first["records"][:2] and all(
        a["loss"] == b["loss"] for a, b in zip(straight["records"][:2], first["records"]))
    s, r = straight["state"], resumed["state"]
    assert s.step == r.step == 4
    for path, x in tts.flatten(s.params).items():
        assert torch.equal(x, tts.flatten(r.params)[path]), path
    so, ro = s.optimizer.state_dict()["state"], r.optimizer.state_dict()["state"]
    for i in so:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(so[i][k], ro[i][k]), (i, k)


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and not (prefix.endswith("partitions.") or "partitions" in k):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_compose_experiment_matches_jax():
    """configs/simlingo.yaml through both composers: every field both
    configs have is equal (the model too: both default to SimLingoConfig(),
    remat on, no LoRA), as are the overrides on top."""
    ov = ["max_steps=7", "data.base.use_town13=false", "optimizer.lr=1e-4"]
    jcfg, tcfg = jcompose("configs/simlingo.yaml", ov), compose("configs/simlingo.yaml", ov)
    j, t = _flat(jto_dict(jcfg)), _flat(to_dict(tcfg))
    shared = set(j) & set(t)
    assert len(shared) > 80 and {"data.train_partitions", "data.base.pred_len", "seed",
                                 "model.llm.lora_r", "model.remat_vision", "model.remat_llm",
                                 "optimizer.lr"} <= shared
    diff = {k: (j[k], t[k]) for k in shared
            if (list(j[k]) if isinstance(j[k], tuple) else j[k])
            != (list(t[k]) if isinstance(t[k], tuple) else t[k])}
    assert not diff, diff
    assert (tcfg.seed, tcfg.max_steps, tcfg.optimizer.lr) == (9876, 7, 1e-4)
    assert len(tcfg.data.train_partitions) == 16 and tcfg.data.use_dreamer
    with pytest.raises(KeyError):
        compose("configs/simlingo.yaml", ["data.base.no_such_key=1"])
    tcfg.mesh.check_supported()                          # dp -1: every process
    for good in ("mesh.fsdp=2", "mesh.dp=4", "mesh.tp=2"):
        compose([good]).mesh.check_supported()
    for good in ("mesh.sp=2", "mesh.pp=2"):                # they compose (A13b)
        compose([good]).mesh.check_supported()
    compose(["mesh.sp=2", "mesh.pp=2", "mesh.tp=2"]).mesh.check_supported()


def test_visualise_writes_the_figures(dataset, tmp_path, capsys):
    """`visualise_every_n_steps`: the waypoint and route grids, the text
    panel and the camera overlay (the raw frame) as PNGs, logged too."""
    root, tdir = dataset
    cfg = compose(_overrides(root, tdir, str(tmp_path), "max_steps=2", "val_every_n_epochs=0",
                             "visualise_every_n_steps=2"))
    cfg.model = _port_cfg(_tiny_jax_cfg())
    TT.train(cfg, device="cpu")
    assert "visualise failed" not in capsys.readouterr().out
    viz = sorted(os.listdir(tmp_path / "run" / "viz"))
    assert viz == [f"viz_{k}_00000002.png" for k in ("camera", "route", "text", "waypoints")]
    assert sum("image" in m for m in _logged(str(tmp_path))) == 4


def test_prefetcher_order_backpressure_and_errors():
    """Steps come back in order from the worker threads, at most ~2 x
    workers are held ahead of the consumer, and a failed batch raises at
    its step."""
    held = []

    def make_batch(step):
        if step == 9:
            raise OSError("unreadable frame")
        return step * step

    pf = TT.Prefetcher(make_batch, start_step=3, num_workers=3)
    try:
        for step in range(3, 9):
            assert pf.get(step) == step * step
            held.append(len(pf.results))
        with pytest.raises(OSError, match="unreadable"):
            pf.get(9)
    finally:
        pf.close()
    assert max(held) <= 2 * 3 + 3
    assert not any(t.is_alive() for t in pf.threads)

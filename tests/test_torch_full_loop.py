"""JAX's whole in-repo loop through the port, against JAX, on the CPU:

    the port's expert collects -> the port's label generators label
    (`collect_dataset_torch.py`) -> the port's trainer trains
    `configs/simlingo.yaml` with commentary, QA, the dreamer mix and the
    generated buckets -> the trained agent drives in the port's microsim.

One module fixture collects the two routes of
`tests/test_microsim_full_loop.py` with the port's expert and labels two
copies of them, one with JAX's `collect_dataset.run_label_generation`, one
with `collect_dataset_torch.py --labels-only`. Then, each held to JAX:
(a) the label files (gzip payloads equal, the header's MTIME masked) and
the bucket pickle (paths relative to their root); (b) the script's job
lists name only the port's modules; (c) both trainers, from one
JAX-initialised tiny model (fp32, no LoRA), 3 steps on their own copy,
logged losses at 2e-4; (d) the two trained agents drive one microsim route
for 6 ticks, waypoints and controls at 2e-4, the ego state at 1e-6.
"""

import dataclasses
import gzip
import importlib.util
import json
import os
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from simlingo_tpu.agent.agent import LingoAgent as JLingoAgent
from simlingo_tpu.agent.config import AgentConfig as JAgentConfig
from simlingo_tpu.core.config import compose as jcompose
from simlingo_tpu.data.tokenizer import SimLingoTokenizer as JTokenizer
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.sim import runner as jrun
from simlingo_tpu.train import trainer as JT
from simlingo_tpu_torch.agent.agent import LingoAgent
from simlingo_tpu_torch.agent.config import AgentConfig
from simlingo_tpu_torch.core import checkpoint as ckpt
from simlingo_tpu_torch.core.config import compose
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
from simlingo_tpu_torch.models import qwen2, simlingo
from simlingo_tpu_torch.sim import runner as trun
from simlingo_tpu_torch.sim import suite as tsuite
from simlingo_tpu_torch.train import train_step as ts
from simlingo_tpu_torch.train import trainer as TT
from tests.test_torch_labels import bucket_table, same_label_files
from tests.test_torch_microsim import _drive, _held_to_jax
from tests.test_torch_train import _port_cfg
from tests.test_torch_trainer_disk import _logged, _tiny_jax_cfg

ROOT = Path(__file__).resolve().parents[1]
ROUTES = "data/simlingo/v1/b0/routes_training"
SPECS = [
    {"town": "straight", "start_s": 5.0, "end_s": 120.0,
     "route_id": "Town12_micro_000",
     "scenarios": [{"type": "ParkedObstacle", "at_s": 70.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 120.0,
     "route_id": "Town12_micro_001",
     "npcs": [{"at_s": 35.0, "lane": 0, "speed": 5.0}]},
]
SEED = 5
STEPS = 3
TICKS = 6


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """(root, {package: its labelled copy}, the port script's stats)."""
    root = tmp_path_factory.mktemp("torch_loop")
    checkpoint = trun.run_routes(SPECS, trun.expert_factory(
        save_root=str(root / "collected" / ROUTES), dir_name_fmt="Town12_micro_{i:03}"))
    for rec in checkpoint["_checkpoint"]["records"]:
        assert rec["status"] in ("Completed", "Perfect"), rec
    copies = {tag: root / tag for tag in ("jax", "torch")}
    for path in copies.values():
        shutil.copytree(root / "collected", path)
    os.environ.pop("OPENAI_API_KEY", None)
    _script("collect_dataset").run_label_generation(str(copies["jax"]))
    stats = _script("collect_dataset_torch").main(["--labels-only", "--save-root",
                                                   str(copies["torch"])])
    return root, copies, stats


def test_labels_equal_jaxs(loop):
    _, copies, stats = loop
    routes = sorted(os.listdir(copies["jax"] / ROUTES))
    assert routes == sorted(os.listdir(copies["torch"] / ROUTES)) == \
        ["Town12_micro_000", "Town12_micro_001"]
    for name in routes:
        j, t = copies["jax"] / ROUTES / name, copies["torch"] / ROUTES / name
        assert same_label_files(j, t) > 0
        for sub in ("commentary", "vqa"):
            assert os.listdir(t / sub), (name, sub)
        got = stats["routes"][str(t)]
        assert {k: v["files"] for k, v in got.items()} == \
            {sub: len(os.listdir(t / sub)) for sub in ("commentary", "vqa", "dreamer")}
    # the first route yields labels in every modality (JAX's own check)
    first = copies["torch"] / ROUTES / routes[0]
    with gzip.open(sorted((first / "vqa").iterdir())[0], "rt") as f:
        record = json.load(f)
    assert sum(len(v) for v in record["QA"].values()) >= 3
    jb, tb = copies["jax"] / "bucketsv2_simlingo", copies["torch"] / "bucketsv2_simlingo"
    assert bucket_table(tb, copies["torch"]) == bucket_table(jb, copies["jax"])
    assert json.loads((tb / "buckets_stats.json").read_text()) == \
        json.loads((jb / "buckets_stats.json").read_text()) == stats["buckets"]
    assert stats["bucket_dir"] == str(tb) and sum(stats["buckets"].values()) > 0


def test_collect_script_names_the_ports_modules(tmp_path):
    CDT = _script("collect_dataset_torch")
    jobs = CDT.microsim_jobs(str(tmp_path), "micro")
    assert [j.name for j in jobs] == [s["route_id"] for s in tsuite.SUITES["micro"]()]
    for job in jobs:
        assert job.cmd[1:3] == ["-m", "simlingo_tpu_torch.sim.suite"]
        assert job.cmd[job.cmd.index("--agent") + 1] == "expert" and "--collect" in job.cmd
        assert not any("simlingo_tpu." in a or "simlingo_tpu/" in a for a in job.cmd)
        assert job.done_file.endswith(os.path.join(f"Town12_{job.name}", "results.json.gz"))
    xml = tmp_path / "routes"
    xml.mkdir()
    (xml / "r0.xml").write_text("<routes/>")
    carla = CDT.carla_jobs(str(xml), str(tmp_path), "lb.py", 2000, 4)
    assert [j.cmd[3] for j in carla] == ["--agent=simlingo_tpu_torch/agent/carla_data_agent.py"]
    assert os.path.isfile(ROOT / "simlingo_tpu_torch" / "agent" / "carla_data_agent.py")


def _overrides(root, out):
    """configs/simlingo.yaml as it stands but for the data root, the
    generated buckets, the split by directory name, the steps and the
    output; a tiny raster and batch, fp32, no validation or saves."""
    return [f"data.data_root={root}", f"data.bucket_path={root}/bucketsv2_simlingo",
            "data.base.use_town13=false", f"max_steps={STEPS}", f"output_dir={out}",
            "name=run", f"seed={SEED}", "precision=fp32", "data.batch_size=2",
            "data.num_workers=2", "data.base.image_size=56", "log_every_n_steps=1",
            "val_every_n_epochs=0", "checkpoint_every_n_steps=0",
            "visualise_every_n_steps=0"]


@pytest.fixture(scope="module")
def trained(loop, tmp_path_factory):
    """Both trainers' runs of `_overrides` from one JAX init of the tiny
    model without LoRA (JAX's default model has none)."""
    _, copies, _ = loop
    out = tmp_path_factory.mktemp("torch_loop_runs")
    jm = _tiny_jax_cfg()
    jm = dataclasses.replace(jm, llm=dataclasses.replace(jm.llm, lora_r=0, lora_alpha=0))
    init = jax.jit(jsim.init_params, static_argnums=1)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JT.simlingo, "init_params", init)
        mp.setattr(JT.ckpt, "save_checkpoint", lambda *a, **k: None)
        jcfg = jcompose("configs/simlingo.yaml", _overrides(copies["jax"], out / "jax"))
        object.__setattr__(jcfg, "model", jm)
        ref = JT.train(jcfg)
    finally:
        mp.undo()
    tcfg = compose("configs/simlingo.yaml", _overrides(copies["torch"], out / "torch"))
    tcfg.model = _port_cfg(jm)
    got = TT.train(tcfg, params=params_from_jax(init(jax.random.PRNGKey(SEED), jm),
                                                device="cpu"), device="cpu")
    return jm, jcfg, tcfg, ref, got, out


def test_labelled_training_matches_jax(trained):
    jm, jcfg, tcfg, ref, got, out = trained
    assert tcfg.data.use_dreamer and tcfg.data.base.use_commentary and tcfg.data.base.use_qa
    assert len(tcfg.data.train_partitions) == 16
    buckets, _ = TT.build_buckets(tcfg)
    names = {b.name for b in buckets}
    assert any(n.endswith("_dreamer") for n in names)
    # a bucket the generated pickle holds is cut to its frames
    sizes = {b.name: b.size for b in buckets}
    assert any(sizes[n] < sizes["all"] for n in names if not n.endswith("_dreamer"))
    assert got["total_steps"] == STEPS
    jsteps = [m for m in _logged(str(out / "jax")) if "loss" in m]
    tsteps = [m for m in _logged(str(out / "torch")) if "loss" in m]
    assert [m["step"] for m in tsteps] == [m["step"] for m in jsteps] == [1, 2, 3]
    for j, t in zip(jsteps, tsteps):
        for k in ("loss", "language_loss", "route_loss", "speed_wps_loss", "grad_norm"):
            np.testing.assert_allclose(t[k], j[k], rtol=2e-4, atol=2e-4, err_msg=k)
    assert all(m["language_loss"] > 0 for m in tsteps)
    # each step's record carries what its batch drew
    for r in got["records"]:
        assert sum(r["buckets"].values()) == tcfg.data.batch_size
        assert set(r["buckets"]) <= names
        assert 0 < r["answer_tokens"] and 0 < r["longest_prompt"] <= tcfg.data.max_text_len


def test_trained_agents_drive_as_jaxs(trained):
    jm, _, _, ref, got, _ = trained
    acfg = dict(use_cot=False, initial_frames_delay=0)
    jagent = JLingoAgent(jax.device_get(ref["state"]["params"]), jm, JAgentConfig(**acfg),
                         tokenizer=JTokenizer(), max_prompt_len=256,
                         compute_dtype=jax.numpy.float32)
    tagent = LingoAgent(got["state"].params, _port_cfg(jm), AgentConfig(**acfg),
                        tokenizer=SimLingoTokenizer(), max_prompt_len=256,
                        compute_dtype=torch.float32, device="cpu")
    j = _drive(jrun, jagent, TICKS)
    t = _drive(trun, tagent, TICKS)
    _held_to_jax(j, t, TICKS)
    assert t[0]["scores"]["score_route"] >= 0.0
    assert np.isfinite(t[0]["scores"]["score_composed"])


def test_trained_model_saves_as_a_simlingo_checkpoint(trained, tmp_path):
    """`save_hf_checkpoint` writes the trained tree in the layout that
    `load_hf_checkpoint` (and `sim/suite.load_model_agent`) reads back
    leaf for leaf, each in its own dtype, and `load_model_agent` serves
    with the trained model's configuration; a LoRA tree is merged into the
    LLM as `qwen2.merge_lora` merges it."""
    jm, _, _, _, got, _ = trained
    cfg = _port_cfg(jm)
    params = got["state"].params
    path = ckpt.save_hf_checkpoint(str(tmp_path / "loop.pt"), params, cfg)
    back = ckpt.load_hf_checkpoint(path, cfg)
    flat, flat_back = ts.flatten(params), ts.flatten(back)
    assert sorted(flat_back) == sorted(flat)
    for k, x in flat.items():
        assert torch.equal(flat_back[k], x.detach().float()), k
    agent = tsuite.load_model_agent(path, device="cpu", model_cfg=cfg)
    assert (agent.model_cfg.vit, agent.model_cfg.llm) == (cfg.vit, cfg.llm)
    agent.close()
    lcfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, lora_r=4, lora_alpha=8))
    lp = simlingo.init_params(lcfg, torch.Generator().manual_seed(1), device="cpu")
    for layer in lp["lora"]["layers"].values():
        for ab in layer.values():
            ab["b"].normal_(generator=torch.Generator().manual_seed(2))
    merged = dict(lp, llm=qwen2.merge_lora(lp["llm"], lp["lora"], lcfg.llm))
    del merged["lora"]
    back = ckpt.load_hf_checkpoint(ckpt.save_hf_checkpoint(
        str(tmp_path / "lora.pt"), lp, lcfg), lcfg)
    for k, x in ts.flatten(merged).items():
        assert torch.equal(ts.flatten(back)[k], x), k
    half = ckpt.save_hf_checkpoint(str(tmp_path / "bf16.pt"), ts.map_leaves(
        lambda _, x: x.detach().bfloat16(), params), cfg)
    assert {v.dtype for v in torch.load(half, weights_only=True).values()} == {torch.bfloat16}
    assert all(torch.equal(v, flat[k].detach().bfloat16().float())
               for k, v in ts.flatten(ckpt.load_hf_checkpoint(half, cfg)).items())

"""simlingo_tpu_torch stands alone: it imports no jax, flax or simlingo_tpu.

A subprocess blocks those imports, imports every module of the port
(the training modules and `parallel/` included: the one-process
`multihost.initialize` is a no-op, `make_mesh` a mesh of one, and the
sequence and pipeline contexts no-ops on it), drives the tiny agent and two training
steps with LoRA dropout on the CPU, then two more with both fused-kernel
gates on, two on an int8 base LLM and two of the tiny SimLingo-Base with
each of its encoders (the CLIP tower, the ResNet); an
entry point built without `device` must refuse on a machine without a GPU.
The first also drives the CARLA leaderboard plugin one tick under the
test doubles of tests/carla_stubs.py, imports `start_eval_torch.py` and
builds its microsim jobs, and runs the microsim suite's CLI (the tiny
model, two ticks of a MicroBench route on the CPU); it collects a short
route with the expert and replays it through the tiny agent, runs the
suite's expert with `--collect`, builds `start_eval_torch.py`'s expert
jobs, and builds `convert_orbax_torch.py`'s template train state (the
script imports orbax only inside the conversion). A further check reads
the converter's imports: orbax, numpy, torch, the standard library and
the port, nothing of the JAX package. A second subprocess, with the same
imports blocked, trains the tiny model two steps from routes on disk
(written by this process beforehand: the route writer uses the JAX
package's label generators), saves, resumes for a third, and evaluates
the saved step through `eval_language_torch.py` (`run_language_eval`);
`train_torch.py` without `--device cpu` refuses where there is no GPU.
A third, with the same imports blocked, imports `collect_dataset_torch.py`,
writes a route with `synthesize_route` and labels it through the script's
`--labels-only` (commentary, VQA, dreamer, the buckets), builds the
script's microsim jobs, splits a route XML with `labels/route_tools` over
the microsim's `MicrosimRouteMap`, decodes its frames with
`decode_crop_batch` and times a call with `utils/profiling`.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

BLOCK = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "flax", "jaxlib") or name == "simlingo_tpu" \\
                    or name.startswith("simlingo_tpu."):
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
""")

SCRIPT = BLOCK + textwrap.dedent("""
    import importlib, pkgutil
    import numpy as np
    import torch
    import simlingo_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        simlingo_tpu_torch.__path__, "simlingo_tpu_torch.")]
    for n in names:
        importlib.import_module(n)
    print("imported", len(names))
    assert {"simlingo_tpu_torch.parallel.mesh",
            "simlingo_tpu_torch.parallel.multihost",
            "simlingo_tpu_torch.parallel.sequence",
            "simlingo_tpu_torch.parallel.pipeline",
            "simlingo_tpu_torch.utils.geometry", "simlingo_tpu_torch.expert.idm",
            "simlingo_tpu_torch.expert.route_planner", "simlingo_tpu_torch.sim.map",
            "simlingo_tpu_torch.sim.actors", "simlingo_tpu_torch.sim.world",
            "simlingo_tpu_torch.sim.camera", "simlingo_tpu_torch.sim.criteria",
            "simlingo_tpu_torch.sim.scenarios", "simlingo_tpu_torch.sim.runner",
            "simlingo_tpu_torch.sim.suite", "simlingo_tpu_torch.eval.driving_score",
            "simlingo_tpu_torch.eval.b2d_benchmarks",
            "simlingo_tpu_torch.orchestration.babysitter",
            "simlingo_tpu_torch.expert.forecast", "simlingo_tpu_torch.expert.autopilot",
            "simlingo_tpu_torch.expert.scenarios", "simlingo_tpu_torch.agent.lidar",
            "simlingo_tpu_torch.agent.data_agent",
            "simlingo_tpu_torch.agent.carla_data_agent",
            "simlingo_tpu_torch.agent.replay",
            "simlingo_tpu_torch.labels.bev_renderer",
            "simlingo_tpu_torch.sim.route_map", "simlingo_tpu_torch.utils.profiling"} \
        | {f"simlingo_tpu_torch.labels.{m}" for m in (
            "vqa_scene", "vqa_vehicles", "vqa_ego", "vqa_road", "vqa", "commentary",
            "dreamer_instructions", "dreamer_gen", "buckets", "augment_templates",
            "dataset_tools", "route_tools")} <= set(names)
    from simlingo_tpu_torch.parallel import mesh as PM, multihost as PH
    from simlingo_tpu_torch.parallel import pipeline as PP, sequence as PS
    assert PH.initialize(device="cpu") is False and PM.make_mesh(device="cpu").world == 1
    one = PM.make_mesh(device="cpu")
    PS.enable(one)
    PP.enable(one)
    assert PS.active_axis() is None and PP.active_axis() is None     # no-ops at size 1

    from simlingo_tpu_torch.agent.agent import AgentFrame, LingoAgent
    from simlingo_tpu_torch.agent.config import AgentConfig
    from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.models.qwen2 import Qwen2Config
    from simlingo_tpu_torch.models.vit import ViTConfig

    tok = SimLingoTokenizer()
    cfg = simlingo.SimLingoConfig(
        vit=ViTConfig(hidden_size=64, num_layers=2, num_heads=4,
                      intermediate_size=128, image_size=448, patch_size=56,
                      projector_out=64),
        llm=Qwen2Config.tiny(vocab_size=tok.tk.vocab_size + 8),
        img_context_token_id=tok.img_context_id)
    params = simlingo.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    agent = LingoAgent(params, cfg, AgentConfig(
        max_new_tokens=4, spec_k=4, initial_frames_delay=0,
        jpeg_roundtrip=False), tokenizer=tok, max_prompt_len=256,
        compute_dtype=torch.float32, device="cpu")
    frame = AgentFrame(rgb=np.zeros((512, 1024, 3), np.uint8), speed=2.0,
                       target_point=np.array([8.0, 0.0]),
                       next_target_point=np.array([16.0, 0.0]))
    for _ in range(2):
        r = agent.run_step(frame)
        assert np.isfinite(r["route"]).all() and len(r["language_tokens"]) == 4
    assert len(agent.spec_stats) == 1

    # the leaderboard plugin under the CARLA test doubles (numpy only)
    from tests import carla_stubs as stubs
    stubs.install_stubs()
    from simlingo_tpu_torch.agent import carla_agent, route_planner
    carla_agent = importlib.reload(carla_agent)       # imported above without CARLA
    plugin = carla_agent.SimLingoTorchAgent.__new__(carla_agent.SimLingoTorchAgent)
    plugin.agent, plugin.logger, plugin.initialized = agent, None, False
    plugin.planner = route_planner.CarlaRoutePlanner()
    plugin._global_plan_world_coord = [((4.0 * i, 0.0, 0.0), 4) for i in range(20)]
    ctrl = plugin.run_step({"rgb_front": (0, np.zeros((512, 1024, 4), np.uint8)),
                            "gps": (0, stubs.gps_for_carla_xy(0.5, 0.0)),
                            "imu": (0, np.zeros(7)), "speed": (0, {"speed": 2.0})}, 0.0)
    assert np.isfinite([ctrl.steer, ctrl.throttle, ctrl.brake]).all()
    plugin.destroy()

    # closed-loop evaluation: start_eval_torch's jobs and the microsim suite
    import os
    import tempfile
    import start_eval_torch
    from simlingo_tpu_torch.sim import suite
    jobs = start_eval_torch.build_jobs(start_eval_torch.parse_args(
        ["--microsim", "--agent-kind", "tiny-model", "--device", "cpu"]))
    assert len(jobs) == 51 and jobs[0].cmd[:3] == ["python", "-m",
                                                   "simlingo_tpu_torch.sim.suite"]
    with tempfile.TemporaryDirectory() as tmp:
        summary = suite.main(["--agent", "tiny-model", "--device", "cpu", "--routes",
                              "micro_02_accident", "--max-steps", "2",
                              "--out", tmp + "/micro.json"])
    assert summary["num_routes"] == 1 and np.isfinite(summary["driving_score"])

    # expert collection, then a replay of it through the tiny agent; the
    # suite's expert with --collect; the orbax converter's port half
    from simlingo_tpu_torch.agent.replay import replay_route
    from simlingo_tpu_torch.sim.runner import expert_factory, run_route
    with tempfile.TemporaryDirectory() as tmp:
        rec = run_route({"town": "straight", "start_s": 5.0, "end_s": 60.0,
                         "route_id": "iso"}, expert_factory(save_root=tmp, seed=0),
                        max_steps=10)
        assert sorted(os.listdir(tmp + "/route_000/rgb")) == ["0000.jpg", "0001.jpg"]
        out = replay_route(agent, tmp + "/route_000")
        assert [o["frame"] for o in out] == [0, 1]
        assert all(np.isfinite([o["steer"], o["throttle"]]).all() for o in out)
        summary = suite.main(["--agent", "expert", "--routes", "micro_00_free",
                              "--max-steps", "10", "--collect", tmp + "/c",
                              "--out", tmp + "/expert.json"])
        assert summary["num_routes"] == 1
        assert os.listdir(tmp + "/c") == ["Town12_micro_00_free"]
    assert len(start_eval_torch.build_jobs(start_eval_torch.parse_args(
        ["--microsim", "--agent-kind", "expert"]))) == 51
    import convert_orbax_torch
    from simlingo_tpu_torch.core.config import TrainConfig
    template = convert_orbax_torch._template(TrainConfig())
    assert len(template.optimizer.param_groups[0]["params"]) == len(template.trainable)

    import dataclasses
    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.data.synthetic import synthetic_example
    from simlingo_tpu_torch.kernels import dropout as TD
    from simlingo_tpu_torch.train import trainer
    tcfg = compose(["max_steps=2", "data.batch_size=2", "data.max_text_len=96",
                    "precision=fp32", "output_dir="])
    tiny = simlingo.SimLingoConfig.tiny()
    tcfg.model = dataclasses.replace(tiny, llm=dataclasses.replace(
        tiny.llm, lora_r=4, lora_alpha=8, lora_dropout=0.1))
    recs = trainer.train(tcfg, make_synthetic=True, device="cpu")["records"]
    assert len(recs) == 2 and all(np.isfinite(r["loss"]) for r in recs)
    assert TD.dropout.launches == 0          # CPU tensors take the plain version

    import os
    from simlingo_tpu_torch.kernels import fused_ce as TCE, layernorm as TLN
    os.environ.update(SIMLINGO_CE_IMPL="pallas", SIMLINGO_LN_IMPL="pallas")
    gated = trainer.train(tcfg, make_synthetic=True, device="cpu")["records"]
    del os.environ["SIMLINGO_CE_IMPL"], os.environ["SIMLINGO_LN_IMPL"]
    assert len(gated) == 2 and all(np.isfinite(r["loss"]) for r in gated)
    assert abs(gated[0]["loss"] - recs[0]["loss"]) <= 1e-4 * abs(recs[0]["loss"])
    assert all(fn.launches == 0 for fn in (
        TCE.fused_ce_fwd, TCE.fused_ce_bwd, TLN.layernorm_fwd, TLN.layernorm_bwd,
        TLN.rmsnorm_fwd, TLN.rmsnorm_bwd))

    from simlingo_tpu_torch.core.quantize import quantize_llm
    from simlingo_tpu_torch.kernels import quantized_matmul as TQM
    p8 = simlingo.init_params(tcfg.model, torch.Generator().manual_seed(tcfg.seed),
                              device="cpu")
    p8["llm"] = quantize_llm(p8["llm"])
    int8 = trainer.train(tcfg, make_synthetic=True, params=p8, device="cpu")["records"]
    assert len(int8) == 2 and all(np.isfinite([r["loss"], r["grad_norm"]]).all()
                                  for r in int8)
    assert abs(int8[0]["loss"] - recs[0]["loss"]) <= 1e-2 * abs(recs[0]["loss"])
    assert TQM.int8_matmul.launches == TQM.int8_matmul_dx.launches == 0

    from simlingo_tpu_torch.core.config import compose_base
    from simlingo_tpu_torch.models import simlingo_base
    bcfg = compose_base(["max_steps=2", "data.batch_size=2", "precision=fp32",
                         "output_dir="])
    bcfg.model = simlingo_base.SimLingoBaseConfig.tiny()
    base = trainer.train_base(bcfg, device="cpu")["records"]
    assert len(base) == 2 and all(np.isfinite(r["loss"]) for r in base)
    from simlingo_tpu_torch.models.resnet import ResNetConfig
    bcfg.model = dataclasses.replace(bcfg.model, encoder="resnet",
                                     resnet=ResNetConfig(width=16, token_size=48))
    base = trainer.train_base(bcfg, device="cpu")["records"]
    assert len(base) == 2 and all(np.isfinite(r["loss"]) for r in base)

    if not torch.cuda.is_available():
        for build in (lambda: LingoAgent(params, cfg),
                      lambda: suite.load_model_agent(None),
                      lambda: simlingo.init_params(cfg, torch.Generator()),
                      lambda: trainer.train(tcfg, make_synthetic=True),
                      lambda: trainer.train_base(bcfg),
                      lambda: synthetic_example(tiny, 1, 96)):
            try:
                build()
            except RuntimeError as e:
                assert "no CUDA GPU" in str(e), e
            else:
                raise AssertionError("entry point without device did not raise")
    assert not any(m == "simlingo_tpu" or m.startswith(("simlingo_tpu.", "jax", "flax"))
                   for m in sys.modules), "a blocked module got imported"
    print("ok")
""")


def test_port_imports_no_jax_and_runs_agent_on_cpu():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok"), res.stdout


def test_orbax_converter_imports_nothing_of_the_jax_package():
    """convert_orbax_torch.py's imports, anywhere in the file: orbax (and
    through it jax), numpy, torch, the standard library and the port."""
    import ast
    tree = ast.parse((ROOT / "convert_orbax_torch.py").read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert {"orbax", "simlingo_tpu_torch"} <= tops
    assert tops <= {"orbax", "numpy", "torch", "simlingo_tpu_torch", "__future__",
                    "argparse", "json", "os", "shutil", "sys", "typing"}, tops


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """chip_smoke.py exits non-zero with no result line when there is no
    GPU, and when it stands alone in a directory without the package."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    cases = [(str(alone), tmp_path)]
    if not torch.cuda.is_available():
        cases.append(("chip_smoke.py", ROOT))
    runs = [subprocess.Popen([sys.executable, script], cwd=cwd, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for script, cwd in cases]                 # both at once
    for proc in runs:
        stdout, _ = proc.communicate(timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in stdout


DISK_SCRIPT = BLOCK + textwrap.dedent("""
    import dataclasses, json, os
    import numpy as np
    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.models.qwen2 import Qwen2Config
    from simlingo_tpu_torch.models.vit import ViTConfig
    from simlingo_tpu_torch.train import trainer
    from tests import torch_routes as R

    root, out = sys.argv[1], sys.argv[2]
    tok = SimLingoTokenizer()
    model = simlingo.SimLingoConfig(
        vit=ViTConfig(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                      image_size=56, patch_size=14, projector_out=32),
        llm=Qwen2Config(vocab_size=tok.tk.vocab_size + 8, hidden_size=32, num_layers=1,
                        num_heads=2, num_kv_heads=1, head_dim=16, intermediate_size=64,
                        lora_r=4, lora_alpha=8, lora_dropout=0.1),
        img_context_token_id=tok.img_context_id, max_answer_len=64)

    def run(steps, *extra):
        cfg = compose(R.data_overrides(root, os.path.join(root, "templates"), batch_size=2)
                      + [f"max_steps={steps}", "precision=fp32", f"output_dir={out}",
                         "val_max_batches=1", "visualise_every_n_steps=0", *extra])
        cfg.model = model
        return trainer.train(cfg, device="cpu")

    first = run(2)
    assert [r["step"] for r in first["records"]] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in first["records"])
    assert np.isfinite(first["metrics"]["val_loss"])
    assert os.listdir(os.path.join(out, "simlingo_tpu", "checkpoints")) == ["step_00000002"]
    again = run(3, "resume=true")
    assert [r["step"] for r in again["records"]] == [3] and again["state"].step == 3

    # eval_language_torch.py (run_language_eval inside) on the saved step,
    # the preset swapped for the tiny model trained above
    import eval_language_torch
    from simlingo_tpu_torch.core import presets
    presets.internvl2_1b = lambda: model
    step = os.path.join(out, "simlingo_tpu", "checkpoints", "step_00000003")
    preds = os.path.join(out, "preds")
    # a data root holding the validation route alone: the CLI's split="val"
    # (the last 1 % of the shuffled routes) is then that route
    val_root = os.path.join(out, "val_root")
    link = os.path.join(val_root, "data", "simlingo", R.VAL_ROUTE)
    os.makedirs(os.path.dirname(link))
    os.symlink(os.path.join(root, "data", "simlingo", R.VAL_ROUTE), link)
    res = eval_language_torch.main(["--checkpoint", step, "--mode", "commentary",
                                    "--data-root", val_root, "--batch-size", "2",
                                    "--num-samples", "3", "--output-dir", preds,
                                    "--device", "cpu"])
    assert set(res["metrics"]) >= {"accuracy", "bleu_4", "cider"}
    with open(os.path.join(preds, "language_preds_all.json")) as f:
        assert len(json.load(f)) == 3
    assert not any(m == "simlingo_tpu" or m.startswith(("simlingo_tpu.", "jax", "flax"))
                   for m in sys.modules), "a blocked module got imported"
    print("ok")
""")


def test_port_trains_from_disk_without_jax(tmp_path):
    from tests import torch_routes as R
    root = tmp_path / "routes"
    root.mkdir()
    R.write_dataset(str(root))
    res = subprocess.run([sys.executable, "-c", DISK_SCRIPT, str(root), str(tmp_path / "out")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "resumed from" in res.stdout and res.stdout.strip().endswith("ok"), res.stdout
    if not torch.cuda.is_available():
        cli = subprocess.run([sys.executable, "train_torch.py", "--synthetic", "max_steps=1",
                              "output_dir="], cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
        assert cli.returncode != 0 and "no CUDA GPU" in cli.stderr, cli.stdout + cli.stderr


LABEL_SCRIPT = BLOCK + textwrap.dedent("""
    import os
    import numpy as np
    import collect_dataset_torch
    from simlingo_tpu_torch.data import imageio
    from simlingo_tpu_torch.data.synthetic import synthesize_route
    from simlingo_tpu_torch.labels import route_tools
    from simlingo_tpu_torch.sim import map as simmap
    from simlingo_tpu_torch.sim.route_map import MicrosimRouteMap
    from simlingo_tpu_torch.utils import profiling

    root = sys.argv[1]
    rd = synthesize_route(root, "v1/b0/routes_training/Town12_iso", n_frames=30,
                          image_hw=(64, 128))
    stats = collect_dataset_torch.main(["--labels-only", "--save-root", root])
    assert list(stats["routes"]) == [rd]
    assert all(stats["routes"][rd][k]["files"] > 0 for k in ("commentary", "vqa"))
    assert os.path.isfile(os.path.join(root, "bucketsv2_simlingo", "buckets_paths.pkl"))
    assert sum(stats["buckets"].values()) > 0
    jobs = collect_dataset_torch.microsim_jobs(os.path.join(root, "m"), "micro")
    assert len(jobs) == 51 and jobs[0].cmd[:3] == ["python", "-m",
                                                   "simlingo_tpu_torch.sim.suite"]

    rmap = MicrosimRouteMap(simmap.crossing_town())
    route = route_tools.ParsedRoute(
        town="Micro", waypoints=np.array([[-100.0, -1.75, 0.0], [100.0, -1.75, 0.0]]),
        scenarios=[], trigger_points=np.zeros((0, 3)), weather_begin=[0.0] * 9,
        weather_end=[0.0] * 9)
    route.build_trace(rmap)
    assert route.trace.shape[1] == 3 and len(route.trace) > 150

    blobs = [open(os.path.join(rd, "rgb", n), "rb").read()
             for n in sorted(os.listdir(os.path.join(rd, "rgb")))[:2]]
    if imageio.decoder()[0] == "native":
        assert imageio.decode_crop_batch(blobs, 64, 128).shape == (2, 45, 128, 3)
    assert set(profiling.timed(lambda: np.ones(3), iters=2, warmup=1)) == {
        "p50_ms", "p90_ms", "mean_ms", "min_ms"}
    assert not any(m == "simlingo_tpu" or m.startswith(("simlingo_tpu.", "jax", "flax"))
                   for m in sys.modules), "a blocked module got imported"
    print("ok")
""")


def test_labelling_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "OPENAI_API_KEY"}
    res = subprocess.run([sys.executable, "-c", LABEL_SCRIPT, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok"), res.stdout

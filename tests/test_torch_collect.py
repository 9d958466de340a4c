"""Expert data collection in the port's microsim against JAX's, on the CPU.

One short route (straight, a parked obstacle, an NPC in the ego's lane),
collected by both packages' `ExpertDriver` with the default 1024x512
camera, `data_save_freq` 5, seed 0 and `SAVE_TF_LABELS=1`, in one module
fixture: the same files, `rgb/`, `rgb_augmented/`, `semantics/`, `depth/`
byte for byte, `boxes/`, `measurements/` and `results.json.gz` byte for
byte but for the gzip header's MTIME field (the write's clock) and equal
once read (measurements key by key), the BEV rasters equal. The port's
index keeps the route through its quality gate. Then, through the port's
copies: JAX's `test_expert_collection_writes_dataset_layout`
(`tests/test_microsim.py`), `test_data_collector_full_sensor_suite`
(`tests/test_agent.py`) and `test_data_agent_plugin_collects_offline`
(`tests/test_carla_plugins.py`, under `tests/carla_stubs.py`, with both
plugins' files compared); the LiDAR round trip across packages;
`replay_route` of the collected route through the same JAX-initialised
tiny agent (the default serving options: CoT, int8 LLM, speculative),
controls within 2e-4 of JAX's; `sim.suite --agent expert` with and
without `--collect`, against JAX's suite; and one babysat
`start_eval_torch.py --microsim --agent-kind expert` job.
"""

import gzip
import importlib
import importlib.util
import itertools
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from simlingo_tpu.agent import lidar as jlidar
from simlingo_tpu.agent import replay as jreplay
from simlingo_tpu.agent.agent import LingoAgent as JLingoAgent
from simlingo_tpu.agent.config import AgentConfig as JAgentConfig
from simlingo_tpu.data.tokenizer import SimLingoTokenizer as JTokenizer
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from simlingo_tpu.models.vit import ViTConfig as JViTConfig
from simlingo_tpu.sim import actors as jactors
from simlingo_tpu.sim import runner as jrun
from simlingo_tpu.sim import suite as jsuite
from simlingo_tpu_torch.agent import lidar as tlidar
from simlingo_tpu_torch.agent import replay as treplay
from simlingo_tpu_torch.agent.agent import LingoAgent
from simlingo_tpu_torch.agent.config import AgentConfig
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.data.index import build_index
from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
from simlingo_tpu_torch.orchestration.babysitter import Babysitter, LocalBackend
from simlingo_tpu_torch.sim import actors as tactors
from simlingo_tpu_torch.sim import runner as trun
from simlingo_tpu_torch.sim import suite as tsuite
from tests import carla_stubs as stubs
from tests.torch_ported import ported_module
from tests.test_torch_train import _port_cfg

ROOT = Path(__file__).resolve().parents[1]
SPEC = {"town": "straight", "start_s": 5.0, "end_s": 40.0, "route_id": "collect",
        "scenarios": [{"type": "ParkedObstacle", "at_s": 25.0}],
        "npcs": [{"at_s": 20.0, "lane": 0, "speed": 5.0}]}
ROUTES = "data/simlingo/v1/b0/routes_training"
GZ = ("boxes", "measurements")
RAW = ("rgb", "rgb_augmented", "semantics", "depth")


def _gz_equal(a: Path, b: Path) -> None:
    """Equal gzip files but for the header's MTIME (bytes 4..8)."""
    x, y = a.read_bytes(), b.read_bytes()
    assert x[:4] + x[8:] == y[:4] + y[8:], a.name
    assert gzip.decompress(x) == gzip.decompress(y), a.name


def _same_dirs(a: Path, b: Path) -> int:
    """The two route directories hold the same files; returns frames."""
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for sub in RAW + GZ + ("bev_semantics",):
        names = sorted(os.listdir(a / sub))
        assert names == sorted(os.listdir(b / sub)), sub
        for n in names:
            if sub in GZ:
                _gz_equal(a / sub / n, b / sub / n)
            elif sub == "bev_semantics":
                ja, jb = np.load(a / sub / n), np.load(b / sub / n)
                assert list(ja) == list(jb) == ["bev"]
                np.testing.assert_array_equal(ja["bev"], jb["bev"])
            else:
                assert (a / sub / n).read_bytes() == (b / sub / n).read_bytes(), (sub, n)
    _gz_equal(a / "results.json.gz", b / "results.json.gz")
    return len(os.listdir(a / "rgb"))


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    root = tmp_path_factory.mktemp("collect")
    old = os.environ.get("SAVE_TF_LABELS")
    os.environ["SAVE_TF_LABELS"] = "1"
    counters = jactors._ids, tactors._ids
    try:
        recs = {}
        for tag, run, actors in (("jax", jrun, jactors), ("torch", trun, tactors)):
            # the boxes carry actor ids, which each package counts from 1 per
            # process: both routes start the count anew, whatever ran before
            actors._ids = itertools.count(1)
            recs[tag] = run.run_route(SPEC, run.expert_factory(
                save_root=str(root / tag / ROUTES), seed=0, dir_name_fmt="Town12_collect"),
                seed=0)
    finally:
        jactors._ids, tactors._ids = counters
        if old is None:
            os.environ.pop("SAVE_TF_LABELS")
        else:
            os.environ["SAVE_TF_LABELS"] = old
    return root, recs


def test_collected_route_equals_jax(collected):
    root, recs = collected
    j, t = recs["jax"], recs["torch"]
    assert t["status"] in ("Completed", "Perfect")
    assert {k: v for k, v in t.items() if k != "meta"} == \
        {k: v for k, v in j.items() if k != "meta"}
    a, b = root / "jax" / ROUTES / "Town12_collect", root / "torch" / ROUTES / "Town12_collect"
    frames = _same_dirs(a, b)
    assert frames >= 30
    for n in sorted(os.listdir(a / "measurements")):
        ma = json.loads(gzip.decompress((a / "measurements" / n).read_bytes()))
        mb = json.loads(gzip.decompress((b / "measurements" / n).read_bytes()))
        assert list(ma) == list(mb)
        for k in ma:
            assert ma[k] == mb[k], (n, k)
    # the expert re-planned around its obstacle, with the NPC in its boxes
    ms = [json.loads(gzip.decompress((b / "measurements" / n).read_bytes()))
          for n in sorted(os.listdir(b / "measurements"))]
    assert any(m["changed_route"] for m in ms)
    assert max(abs(m["pos_global"][1] + 1.75) for m in ms) > 2.0     # left its lane
    boxes = json.loads(gzip.decompress((b / "boxes" / "0010.json.gz").read_bytes()))
    assert sum(x.get("type_id", "").startswith("vehicle.") for x in boxes) == 2


def test_collected_route_passes_the_index_gate(collected):
    root, _ = collected
    idx = build_index(str(root / "torch"), split="train", use_town13=False, pred_len=11)
    assert len(idx) > 0
    assert {os.path.basename(os.fsdecode(r)) for r in idx.route_dirs} == {"Town12_collect"}


@pytest.mark.parametrize("test_file,test", [
    ("test_microsim", "test_expert_collection_writes_dataset_layout"),
    ("test_agent", "test_data_collector_full_sensor_suite")])
def test_jax_collection_tests_through_the_port(test_file, test, tmp_path):
    getattr(ported_module(test_file), test)(tmp_path)


def test_lidar_round_trip_across_packages(tmp_path):
    rng = np.random.RandomState(0)
    prev, cur = rng.randn(300, 4) * 10, rng.randn(280, 4) * 10
    full = tlidar.realign_half_sweeps(prev, cur, np.zeros(2), 0.0, np.array([1.0, 0.2]), 0.1)
    assert full.shape == (580, 4)
    path_t = tlidar.save_lidar(str(tmp_path / "torch_0001"), full)
    path_j = jlidar.save_lidar(str(tmp_path / "jax_0001"), full)
    assert os.path.splitext(path_t)[1] == os.path.splitext(path_j)[1]
    for path in (path_t, path_j):
        for load in (tlidar.load_lidar, jlidar.load_lidar):
            back = load(path)
            np.testing.assert_allclose(back[:, :3], full[:, :3], atol=1e-3)
    np.testing.assert_array_equal(tlidar.load_lidar(path_t), jlidar.load_lidar(path_j))


# ---------------------------------------------------------------------------
# the CARLA data plugin under the test doubles
# ---------------------------------------------------------------------------

DATA_PLUGINS = ("simlingo_tpu.agent.carla_data_agent",
                "simlingo_tpu_torch.agent.carla_data_agent")
STUB_MODULES = ("carla", "leaderboard", "leaderboard.autoagents",
                "leaderboard.autoagents.autonomous_agent", "srunner",
                "srunner.scenariomanager", "srunner.scenariomanager.carla_data_provider")


@pytest.fixture()
def carla_env(tmp_path):
    """The world of tests/test_carla_plugins.py's fixture, both data plugins
    reloaded under it; afterwards the doubles removed and the plugins
    reloaded without them."""
    ego_wp = stubs.FakeWaypoint(lane_id=-2, left_marking="Broken", right_marking="Solid")
    left_same = stubs.FakeWaypoint(lane_id=-1)
    opposite = stubs.FakeWaypoint(lane_id=1)
    ego_wp._left = left_same
    left_same._left = opposite
    ego_wp._next = stubs.FakeWaypoint(lane_id=-2, is_junction=True)
    actors = [stubs.FakeActor(7, "vehicle.lincoln.mkz", x=12.0, y=1.0, vx=4.0),
              stubs.FakeActor(9, "walker.pedestrian.0001", x=6.0, y=-3.0, vy=1.0),
              stubs.FakeActor(99, "vehicle.far.away", x=200.0, y=0.0),
              stubs.FakeActor(11, "static.prop.trafficwarning", x=20.0, y=0.0)]
    cdp = stubs.install_stubs(world=stubs.FakeWorld(actors), world_map=stubs.FakeMap(ego_wp))
    mods = [importlib.reload(importlib.import_module(n)) for n in DATA_PLUGINS]
    yield cdp, tmp_path, mods
    for name in STUB_MODULES:
        sys.modules.pop(name, None)
    for name in DATA_PLUGINS:
        importlib.reload(sys.modules[name])


def test_data_plugin_collects_as_jaxs(carla_env, monkeypatch):
    cdp, tmp_path, (jplugin, tplugin) = carla_env
    assert tplugin.get_entry_point() == "SimLingoTorchDataAgent"
    monkeypatch.setenv("SAVE_PATH", str(tmp_path / "collect"))
    ported = ported_module("test_carla_plugins",
                           renames=[("SimLingoTPUDataAgent", "SimLingoTorchDataAgent")])
    ported.test_data_agent_plugin_collects_offline((cdp, tmp_path))
    # both plugins on the same inputs: the same controls and files
    controls = {}
    for tag, plugin, cls in (("jax", jplugin, "SimLingoTPUDataAgent"),
                             ("torch", tplugin, "SimLingoTorchDataAgent")):
        out = tmp_path / f"both_{tag}"
        monkeypatch.setenv("SAVE_PATH", str(out))
        agent = getattr(plugin, cls).__new__(getattr(plugin, cls))
        agent.setup(str(out))
        agent._global_plan_world_coord = ported._plan()
        controls[tag] = []
        for i in range(6):
            c = agent.run_step(ported._input_data(x=1.0 + 0.25 * i), timestamp=i * 0.05)
            controls[tag].append((c.steer, c.throttle, c.brake))
        agent.destroy()
    assert controls["torch"] == controls["jax"]
    a, b = tmp_path / "both_jax", tmp_path / "both_torch"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for sub in GZ:
        names = sorted(os.listdir(a / sub))
        assert names and names == sorted(os.listdir(b / sub))
        for n in names:
            _gz_equal(a / sub / n, b / sub / n)
    for sub in ("rgb", "rgb_augmented"):
        for n in sorted(os.listdir(a / sub)):
            assert (a / sub / n).read_bytes() == (b / sub / n).read_bytes()


# ---------------------------------------------------------------------------
# replay of the collected route through the tiny agent
# ---------------------------------------------------------------------------

REPLAY = dict(initial_frames_delay=0, max_new_tokens=6, spec_k=4, warmup_compile=False)


def test_replay_of_the_collected_route_matches_jax(collected):
    root, _ = collected
    tok = JTokenizer()
    jcfg = jsim.SimLingoConfig(
        vit=JViTConfig(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                       image_size=448, patch_size=56, projector_out=64),
        llm=JQwen2Config.tiny(vocab_size=tok.tk.vocab_size + 8),
        img_context_token_id=tok.img_context_id, remat_vision=False, remat_llm=False)
    params = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(2), jcfg)
    jagent = JLingoAgent(params, jcfg, JAgentConfig(**REPLAY), tokenizer=tok,
                         max_prompt_len=256, compute_dtype=jax.numpy.float32)
    tagent = LingoAgent(params_from_jax(params, device="cpu"), _port_cfg(jcfg),
                        AgentConfig(**REPLAY), tokenizer=SimLingoTokenizer(),
                        max_prompt_len=256, compute_dtype=torch.float32, device="cpu")
    route = str(root / "torch" / ROUTES / "Town12_collect")
    j = jreplay.replay_route(jagent, route, max_frames=3, start_frame=10)
    t = treplay.replay_route(tagent, route, max_frames=3, start_frame=10)
    assert [o["frame"] for o in t] == [o["frame"] for o in j] == [10, 11, 12]
    for a, b in zip(j, t):
        np.testing.assert_allclose([b["steer"], b["throttle"]], [a["steer"], a["throttle"]],
                                   atol=2e-4, rtol=2e-4)
        assert bool(b["brake"]) == bool(a["brake"])
        for key in ("route", "speed_wps"):
            np.testing.assert_allclose(b[key], a[key], atol=2e-4, rtol=2e-4, err_msg=key)
        assert b["language"] == a["language"]
        assert b["expert"] == a["expert"] and b["expert"]["steer"] is not None
    assert len(tagent.spec_stats) == 2 and tagent.spec_stats == jagent.spec_stats


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

SUITE_ARGS = ["--agent", "expert", "--routes", "micro_00_free", "--max-steps", "30"]


def _records(path):
    recs = json.loads(Path(path).read_text())["_checkpoint"]["records"]
    for r in recs:
        r["meta"] = {k: v for k, v in r["meta"].items() if "system" not in k}
    return recs


def test_suite_expert_with_and_without_collect_equals_jax(tmp_path, capsys):
    for collect in (False, True):
        outs = {}
        for tag, suite in (("jax", jsuite), ("torch", tsuite)):
            argv = SUITE_ARGS + ["--out", str(tmp_path / f"{tag}_{collect}.json")]
            if collect:
                argv += ["--collect", str(tmp_path / f"data_{tag}")]
            outs[tag] = suite.main(argv)
        assert outs["torch"] == outs["jax"]
        assert _records(tmp_path / f"torch_{collect}.json") == \
            _records(tmp_path / f"jax_{collect}.json")
    assert "agent:" not in capsys.readouterr().out          # no model ran
    a, b = tmp_path / "data_jax" / "Town12_micro_00_free", \
        tmp_path / "data_torch" / "Town12_micro_00_free"
    assert sorted(os.listdir(b / "rgb")) == [f"{i:04}.jpg" for i in range(6)]
    for sub in ("rgb", "rgb_augmented"):
        for n in sorted(os.listdir(a / sub)):
            assert (a / sub / n).read_bytes() == (b / sub / n).read_bytes()
    for sub in GZ:
        for n in sorted(os.listdir(a / sub)):
            _gz_equal(a / sub / n, b / sub / n)
    _gz_equal(a / "results.json.gz", b / "results.json.gz")


def test_start_eval_torch_runs_an_expert_job(tmp_path, monkeypatch):
    """start_eval_torch's expert job for micro_00_free (20 steps), babysat,
    then merged by `summarize`."""
    monkeypatch.chdir(ROOT)
    spec = importlib.util.spec_from_file_location("start_eval_torch",
                                                  ROOT / "start_eval_torch.py")
    SE = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(SE)
    out = tmp_path / "eval"
    out.mkdir()
    jobs = SE.build_jobs(SE.parse_args(["--microsim", "--agent-kind", "expert",
                                        "--output-dir", str(out)]))
    assert len(jobs) == len(tsuite.SUITES["micro"]())
    job = next(j for j in jobs if j.name == "micro_00_free")
    assert job.cmd[job.cmd.index("--agent") + 1] == "expert" and "--checkpoint" not in job.cmd
    job.cmd = job.cmd + ["--max-steps", "20"]
    counts = Babysitter([job], LocalBackend(), poll_interval_s=0.2, hang_timeout_s=300).run()
    log = Path(job.log_path).read_text()
    assert counts == {"running": 0, "finished": 1, "failed": 0, "pending": 0}, log
    rec = json.loads(Path(job.done_file).read_text())["_checkpoint"]["records"][0]
    assert rec["route_id"] == "micro_00_free" and rec["meta"]["duration_game"] == 1.0
    summary = SE.summarize(str(out))
    assert summary["num_routes"] == 1
    assert summary == json.loads((out / "merged.json").read_text())

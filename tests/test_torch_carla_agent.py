"""The port's CARLA leaderboard plugin against JAX's, offline (CPU, fp32).

Both plugins run under the CARLA / leaderboard test doubles of
`tests/carla_stubs.py` (the JAX one built as `tests/test_carla_plugins.py`
builds it), from the same JAX-initialised tiny model, with the default
serving options (CoT, int8 LLM, speculative after the first tick) and
the per-tick metric file and scenario records on. Along one straight plan
the ticks' steer / throttle / brake agree within 2e-4, the records'
ego actions and the metric lines (but latency_ms) agree, and the route
planner's GPS -> CARLA conversion inverts the stubs' projection. The
port's `setup()` is driven too, on a tiny checkpoint in the trained
SimLingo layout. The fixture removes the doubles and reloads both plugin
modules, so later tests see no simulator.
"""

import dataclasses
import gzip
import importlib
import json
import sys

import jax
import numpy as np
import pytest
import torch

from simlingo_tpu.agent.agent import LingoAgent as JLingoAgent
from simlingo_tpu.agent.config import AgentConfig as JAgentConfig
from simlingo_tpu.agent.route_planner import CarlaRoutePlanner as JPlanner
from simlingo_tpu.agent.scenario_logger import ScenarioLogger as JLogger
from simlingo_tpu.data.tokenizer import SimLingoTokenizer as JTokenizer
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from simlingo_tpu.models.vit import ViTConfig as JViTConfig
from simlingo_tpu_torch.agent.agent import LingoAgent
from simlingo_tpu_torch.agent.config import AgentConfig
from simlingo_tpu_torch.agent.route_planner import CarlaRoutePlanner
from simlingo_tpu_torch.agent.scenario_logger import ScenarioLogger
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
from tests import carla_stubs as stubs
from tests.test_torch_train import _port_cfg

PLUGINS = ("simlingo_tpu.agent.carla_agent", "simlingo_tpu_torch.agent.carla_agent")
STUB_MODULES = ("carla", "leaderboard", "leaderboard.autoagents",
                "leaderboard.autoagents.autonomous_agent", "srunner",
                "srunner.scenariomanager", "srunner.scenariomanager.carla_data_provider")
AGENT = dict(initial_frames_delay=0, max_new_tokens=6, spec_k=4, warmup_compile=False)
TICKS = 3


@pytest.fixture()
def carla_env():
    stubs.install_stubs(world=stubs.FakeWorld())
    mods = [importlib.reload(importlib.import_module(n)) for n in PLUGINS]
    yield mods
    for name in STUB_MODULES:
        sys.modules.pop(name, None)
    for name in PLUGINS:
        importlib.reload(sys.modules[name])


@pytest.fixture(scope="module")
def model():
    tok = JTokenizer()
    jcfg = jsim.SimLingoConfig(
        vit=JViTConfig(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                       image_size=448, patch_size=56, projector_out=64),
        llm=JQwen2Config.tiny(vocab_size=tok.tk.vocab_size + 8),
        img_context_token_id=tok.img_context_id, remat_vision=False, remat_llm=False)
    params = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    return jcfg, params, _port_cfg(jcfg), params_from_jax(params, device="cpu")


def _plan(n=30, spacing=4.0):
    """A straight global plan along +x in CARLA world coordinates."""
    return [((float(i * spacing), 0.0, 0.0), 4) for i in range(n)]


def _input_data(x, speed):
    rgb = np.random.RandomState(int(x * 8)).randint(0, 256, (512, 1024, 4), np.uint8)
    return {"rgb_front": (0, rgb), "gps": (0, stubs.gps_for_carla_xy(x, 0.1)),
            "imu": (0, np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.02])),
            "speed": (0, {"speed": speed})}


def _plugin(cls, agent, planner, logger):
    plugin = cls.__new__(cls)
    plugin.agent, plugin.planner, plugin.logger = agent, planner, logger
    plugin.initialized = False
    plugin._global_plan_world_coord = _plan()
    return plugin


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_plugin_ticks_match_jax(carla_env, model, tmp_path, monkeypatch):
    jplug_mod, tplug_mod = carla_env
    assert tplug_mod.get_entry_point() == "SimLingoTorchAgent"
    assert tplug_mod.SimLingoTorchAgent is not None
    jcfg, jparams, tcfg, tparams = model
    built = []
    for tag, make in (
            ("jax", lambda: _plugin(
                jplug_mod.SimLingoTPUAgent,
                JLingoAgent(jparams, jcfg, JAgentConfig(**AGENT), tokenizer=JTokenizer(),
                            max_prompt_len=256, compute_dtype=jax.numpy.float32),
                JPlanner(min_distance=7.5, max_distance=50.0),
                JLogger(save_path=str(tmp_path / "jax_rec"), route_index="0"))),
            ("torch", lambda: _plugin(
                tplug_mod.SimLingoTorchAgent,
                LingoAgent(tparams, tcfg, AgentConfig(**AGENT), tokenizer=SimLingoTokenizer(),
                           max_prompt_len=256, compute_dtype=torch.float32, device="cpu"),
                CarlaRoutePlanner(min_distance=7.5, max_distance=50.0),
                ScenarioLogger(save_path=str(tmp_path / "torch_rec"), route_index="0")))):
        monkeypatch.setenv("SIMLINGO_METRIC_INFO", str(tmp_path / f"{tag}_metrics.jsonl"))
        built.append(make())
    jplug, tplug = built

    for i in range(TICKS):
        data = _input_data(x=0.5 + 1.2 * i, speed=4.0 + 0.3 * i)
        cj = jplug.run_step(data, timestamp=0.05 * i)
        ct = tplug.run_step(data, timestamp=0.05 * i)
        for name in ("steer", "throttle", "brake"):
            assert getattr(ct, name) == pytest.approx(getattr(cj, name), abs=2e-4, rel=2e-4)
        assert tplug.agent.last_language == jplug.agent.last_language
    assert len(tplug.agent.spec_stats) == TICKS - 1
    assert tplug.agent.spec_stats == jplug.agent.spec_stats
    jplug.destroy()
    tplug.destroy()

    recs = []
    for tag in ("jax", "torch"):
        with gzip.open(tmp_path / f"{tag}_rec" / "records.json.gz", "rt") as f:
            recs.append(json.load(f))
    jrec, trec = recs
    assert len(trec["states"]) == TICKS and trec["meta_data"] == jrec["meta_data"]
    np.testing.assert_allclose(
        [[a[k][0][0][0] for k in ("steer", "throttle", "brake")] for a in trec["ego_actions"]],
        [[a[k][0][0][0] for k in ("steer", "throttle", "brake")] for a in jrec["ego_actions"]],
        atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(trec["states"][-1]["pos"], jrec["states"][-1]["pos"], atol=1e-9)
    assert trec["route"] == jrec["route"] and trec["lights"] == jrec["lights"]

    jl, tl = _lines(tmp_path / "jax_metrics.jsonl"), _lines(tmp_path / "torch_metrics.jsonl")
    assert len(tl) == len(jl) == TICKS
    for a, b in zip(tl, jl):
        assert set(a) == set(b) == {"step", "steer", "throttle", "brake", "speed",
                                    "latency_ms", "language"}
        assert (a["step"], a["brake"], a["language"]) == (b["step"], b["brake"], b["language"])
        for k in ("steer", "throttle", "speed"):
            assert a[k] == pytest.approx(b[k], abs=2e-4, rel=2e-4), k
    assert tplug.agent._metric_file is None                     # closed by destroy()


def test_planner_round_trips_gps_like_jax():
    tp, jp = CarlaRoutePlanner(), JPlanner()
    for x, y in ((12.5, -3.0), (0.0, 0.0), (-250.25, 731.5)):
        gps = stubs.gps_for_carla_xy(x, y)
        pos = tp.convert_gps_to_carla(gps)
        np.testing.assert_allclose(pos[:2], [x, y], atol=1e-6)
        np.testing.assert_array_equal(pos, jp.convert_gps_to_carla(gps))
    tp.set_route(_plan())
    jp.set_route(_plan())
    for x in (0.0, 9.0, 30.5):
        a = tp.target_points(np.array([x, 0.4]), 0.03)
        b = jp.target_points(np.array([x, 0.4]), 0.03)
        np.testing.assert_array_equal(np.stack(a), np.stack(b))


def test_setup_loads_a_trained_checkpoint(carla_env, model, tmp_path, monkeypatch):
    """setup() on a tiny checkpoint in the trained SimLingo layout (the
    writer chip_smoke.py uses at full width), on the CPU: the default
    AgentConfig, the metric file and the scenario records."""
    import chip_smoke
    from simlingo_tpu_torch.core import presets
    _, tplug_mod = carla_env
    _, _, tcfg, _ = model
    tcfg = dataclasses.replace(tcfg, llm=dataclasses.replace(tcfg.llm, lora_r=32,
                                                             lora_alpha=64))
    path = tmp_path / "simlingo.pt"
    torch.save(chip_smoke.simlingo_state_dict(tcfg, torch, "cpu"), path)
    monkeypatch.setattr(presets, "internvl2_1b", lambda: tcfg)
    monkeypatch.setenv("SIMLINGO_METRIC_INFO", str(tmp_path / "metrics.jsonl"))
    monkeypatch.setenv("SIMLINGO_RECORD_DIR", str(tmp_path / "records"))
    plugin = tplug_mod.SimLingoTorchAgent()
    plugin.device = "cpu"
    plugin.setup(str(path), route_index=3)
    assert plugin.agent.cfg == AgentConfig()
    assert [s["id"] for s in plugin.sensors()] == ["rgb_front", "imu", "gps", "speed"]
    plugin.agent.cfg.initial_frames_delay = 0
    plugin._global_plan_world_coord = _plan()
    controls = [plugin.run_step(_input_data(x=0.5 + i, speed=3.0), timestamp=0.05 * i)
                for i in range(2)]
    assert all(np.isfinite([c.steer, c.throttle, c.brake]).all() for c in controls)
    plugin.destroy()
    lines = _lines(tmp_path / "metrics.jsonl")
    assert [ln["step"] for ln in lines] == [1, 2]
    with gzip.open(tmp_path / "records" / "3" / "records.json.gz", "rt") as f:
        assert len(json.load(f)["ego_actions"]) == 2

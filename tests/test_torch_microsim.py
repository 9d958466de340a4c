"""The port's microsim (`simlingo_tpu_torch/sim/`) against JAX's, on the CPU.

The world, its criteria, the 44 Bench2Drive scenario builders and the
camera are numpy copies: driven by the same scripted controls, both
packages' worlds hold equal states tick by tick (every actor's fields,
the lights, the scenario mechanics and the world's RandomState; actor ids
relative to the world's first, as each package counts its own), and equal
criteria records (all but the wall time). The camera renders equal uint8
frames. In closed loop, the same JAX-initialised tiny model (carried over
with `params_from_jax`) drives "straight" for 8 ticks through each
package's `ModelDriver`, plain and with GNSS / compass noise through the
agent's UKF: each tick's steer / throttle / brake (and the waypoints the
controller took them from) within 2e-4 of JAX's, and
the route records' status, infractions and scores equal. The worlds run
free: each package's agent sees its own camera frame; the egos' poses
agree to 1e-6 m and the frames are held equal, so no lock-step comparison
is needed. The default
agent (CoT, int8 LLM, speculative after the first tick) does the same
over 4 ticks, with equal commentary.
"""

import math

import jax
import numpy as np
import pytest
import torch

from simlingo_tpu.agent.agent import LingoAgent as JLingoAgent
from simlingo_tpu.agent.config import AgentConfig as JAgentConfig
from simlingo_tpu.data.tokenizer import SimLingoTokenizer as JTokenizer
from simlingo_tpu.eval.b2d_benchmarks import ABILITIES
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from simlingo_tpu.models.vit import ViTConfig as JViTConfig
from simlingo_tpu.sim import camera as jcam
from simlingo_tpu.sim import criteria as jcrit
from simlingo_tpu.sim import map as jmap
from simlingo_tpu.sim import runner as jrun
from simlingo_tpu.sim import suite as jsuite
from simlingo_tpu.sim import world as jworld
from simlingo_tpu_torch.agent.agent import LingoAgent
from simlingo_tpu_torch.agent.config import AgentConfig
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
from simlingo_tpu_torch.sim import camera as tcam
from simlingo_tpu_torch.sim import criteria as tcrit
from simlingo_tpu_torch.sim import map as tmap
from simlingo_tpu_torch.sim import runner as trun
from simlingo_tpu_torch.sim import suite as tsuite
from simlingo_tpu_torch.sim import world as tworld
from tests.test_torch_train import _port_cfg

ALL_TYPES = sorted({n for v in ABILITIES.values() for n in v})
PKGS = {"jax": (jrun, jcrit, jworld, jmap, jcam), "torch": (trun, tcrit, tworld, tmap, tcam)}


# ---------------------------------------------------------------------------
# world state, canonical: equal canons mean equal worlds
# ---------------------------------------------------------------------------

def _canon(x, base, depth=0):
    """Plain data of x: numpy as lists, lanes by id, actors nested in
    another object by id relative to `base`, objects by their fields."""
    if isinstance(x, np.ndarray):
        return ["ndarray", str(x.dtype), x.tolist()]
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (list, tuple)):
        return [_canon(v, base, depth) for v in x]
    if isinstance(x, dict):
        return {str(k): _canon(v, base, depth) for k, v in sorted(x.items(), key=str)}
    name = type(x).__name__
    if name == "Lane":
        return ["lane", x.lane_id]
    if hasattr(x, "actor_id") and depth > 0:
        return ["actor", x.actor_id - base]
    if hasattr(x, "__dict__"):
        return [name, {k: (v - base if k == "actor_id" else _canon(v, base, depth + 1))
                       for k, v in sorted(vars(x).items())}]
    raise TypeError(f"no canon for {name}")


def _world_state(world):
    base = min(a.actor_id for a in world.actors)
    rng = world.rng.get_state()
    return _canon({"time": world.time, "frame": world.frame, "actors": world.actors,
                   "lights": world.lights, "faults": world.control_faults,
                   "triggers": world.light_triggers,
                   "rng": [rng[0], rng[1], *rng[2:]]}, base)


def _record(rec):
    """A route record without its wall time."""
    rec = dict(rec, meta={k: v for k, v in rec["meta"].items() if k != "duration_system"})
    return _canon(rec, 0)


def _setup_red_light(world):
    for light in world.lights:
        light.frozen = "red" if light.spot.lane_id == 0 else "green"


def _setup_off_road(world):
    world.ego.yaw = math.pi / 2            # drive straight off the road


# (name, spec, setup, control, ticks, the criterion that must fire): the
# drives of tests/test_microsim.py's criteria tests, plus the curved town
CRITERIA = {
    "red_light": ({"town": "crossing", "start_s": 100.0, "end_s": 290.0, "route_id": "redrun"},
                  _setup_red_light, (0.0, 0.75, 0.0), 2000, "red_light"),
    "collision": ({"town": "straight", "start_s": 5.0, "end_s": 220.0, "route_id": "crash",
                   "scenarios": [{"type": "ParkedObstacle", "at_s": 60.0}]},
                  None, (0.0, 0.75, 0.0), 1000, "collisions_vehicle"),
    "blocked": ({"town": "straight", "start_s": 5.0, "end_s": 100.0, "route_id": "stuck"},
                None, (0.0, 0.0, 1.0), int(95.0 / 0.05), None),
    "deviation": ({"town": "straight", "start_s": 5.0, "end_s": 200.0, "route_id": "dev"},
                  _setup_off_road, (0.0, 0.6, 0.0), 1500, "route_dev"),
    "curved_invading": ({"town": "curved", "start_s": 5.0, "end_s": 240.0, "route_id": "inv",
                         "scenarios": [{"type": "InvadingTurn", "at_s": 100.0}]},
                        None, (0.05, 0.5, 0.0), 600, None),
}


@pytest.mark.parametrize("case", sorted(CRITERIA))
def test_scripted_drives_give_jax_worlds_and_records(case):
    spec, setup, control, ticks, fires = CRITERIA[case]
    sims = {}
    for tag, (run, crit, *_rest) in PKGS.items():
        world, route, scen = run.build_world(spec)
        if setup is not None:
            setup(world)
        sims[tag] = (world, crit.RouteCriteria(world, route), run.scripted_tick)
    assert _world_state(sims["torch"][0]) == _world_state(sims["jax"][0])
    finished = {}
    for i in range(ticks):
        for tag, (world, crit, scripted_tick) in sims.items():
            if tag in finished:
                continue
            world.apply_ego_control(*control)
            world.tick()
            scripted_tick(world)
            crit.update()
            if crit.finished:
                finished[tag] = i
        if i % 50 == 0 or finished:
            assert _world_state(sims["torch"][0]) == _world_state(sims["jax"][0]), (case, i)
        if len(finished) == 2 or (finished and i > max(finished.values())):
            break
    assert finished.get("torch") == finished.get("jax")
    recs = [_record(sims[t][1].record(route_id=spec["route_id"], wall_time=1.0))
            for t in ("jax", "torch")]
    assert recs[1] == recs[0]
    if fires is not None:
        assert sims["torch"][1].record()["infractions"][fires], case
    if case == "blocked":
        assert sims["torch"][1].finished == "Failed - Agent got blocked"


@pytest.mark.parametrize("name", ALL_TYPES)
def test_scenario_builder_spawns_as_jax(name):
    """Each Bench2Drive type on its MicroBench route: the same route, the
    same actors at the same poses (and every other field), the same
    mechanics and scenario records, and the same world after 40 ticks."""
    spec = next(s for s in tsuite.MICROBENCH
                if s.get("scenarios") and s["scenarios"][0]["type"] == name)
    assert spec in jsuite.MICROBENCH
    built = {}
    for tag, (run, *_rest) in PKGS.items():
        world, route, recs = run.build_world(spec, seed=3)
        base = min(a.actor_id for a in world.actors)
        built[tag] = (world, route, _canon(recs, 0), base)
    (jw, jroute, jrecs, jbase), (tw, troute, trecs, tbase) = built["jax"], built["torch"]
    np.testing.assert_array_equal(troute, jroute)
    assert len(tw.actors) == len(jw.actors) >= 1
    assert _world_state(tw) == _world_state(jw)

    def rel(recs, base):
        return [dict(r, first_actor=dict(r["first_actor"], id=r["first_actor"]["id"] - base))
                if isinstance(r, dict) and isinstance(r.get("first_actor"), dict) else r
                for r in recs]
    assert rel(trecs, tbase) == rel(jrecs, jbase)
    for world, run in ((jw, jrun), (tw, trun)):
        for _ in range(40):
            world.apply_ego_control(0.0, 0.5, 0.0)
            world.tick()
            run.scripted_tick(world)
    assert _world_state(tw) == _world_state(jw)


def test_suites_equal_jax():
    assert tsuite.MICROBENCH == jsuite.MICROBENCH
    assert tsuite.microbench220() == jsuite.microbench220()
    assert sorted(tsuite.SUITES) == sorted(jsuite.SUITES)


def test_camera_renders_jax_frames():
    """The pinhole RGB (and the semantics and depth) of a scenario world at
    1024x512, after a few ticks; and a shifted pose."""
    spec = next(s for s in tsuite.MICROBENCH if s["route_id"] == "micro_12_bicycle_flow")
    frames = {}
    for tag, (run, _c, _w, _m, cam) in PKGS.items():
        world, _, _ = run.build_world(spec, seed=1)
        world.ego.position = world.ego.position + np.array([100.0, 0.0])
        for _ in range(30):
            world.apply_ego_control(0.0, 0.4, 0.0)
            world.tick()
            run.scripted_tick(world)
        camera = cam.Camera()
        frames[tag] = (camera.render(world, with_labels=True),
                       camera.render(world, pose=(world.ego.position + np.array([0.3, 0.5]),
                                                  world.ego.yaw + 0.05))["rgb"])
    (jout, jshift), (tout, tshift) = frames["jax"], frames["torch"]
    assert tout["rgb"].shape == (512, 1024, 3) and tout["rgb"].dtype == np.uint8
    assert len(np.unique(tout["semantics"])) >= 4          # road, marking, vehicle, sky ...
    for key in ("rgb", "semantics", "depth"):
        np.testing.assert_array_equal(tout[key], jout[key])
    np.testing.assert_array_equal(tshift, jshift)


# ---------------------------------------------------------------------------
# closed loop: the same tiny model through both packages' ModelDriver
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    tok = JTokenizer()
    jcfg = jsim.SimLingoConfig(
        vit=JViTConfig(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                       image_size=448, patch_size=56, projector_out=64),
        llm=JQwen2Config.tiny(vocab_size=tok.tk.vocab_size + 8),
        img_context_token_id=tok.img_context_id, remat_vision=False, remat_llm=False)
    params = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, _port_cfg(jcfg), params_from_jax(params, device="cpu")


SPEC = {"town": "straight", "start_s": 5.0, "end_s": 120.0, "route_id": "model_loop"}
PLAIN = dict(use_cot=False, initial_frames_delay=0)
DEFAULT = dict(initial_frames_delay=0, max_new_tokens=6, spec_k=4, warmup_compile=False)


def _agents(model, acfg, prompt_len):
    jcfg, jparams, tcfg, tparams = model
    return (JLingoAgent(jparams, jcfg, JAgentConfig(**acfg), tokenizer=JTokenizer(),
                        max_prompt_len=prompt_len, compute_dtype=jax.numpy.float32),
            LingoAgent(tparams, tcfg, AgentConfig(**acfg), tokenizer=SimLingoTokenizer(),
                       max_prompt_len=prompt_len, compute_dtype=torch.float32, device="cpu"))


def _drive(run, agent, ticks, **kw):
    """run_route with `agent` through `run.model_factory`: the record, each
    tick's applied control and ego state, the frames the agent saw and its
    waypoints (route, speed) before the controller."""
    controls, frames, wps, inner = [], [], [], agent.run_step

    def capture(frame):
        frames.append(frame.rgb)
        out = inner(frame)
        wps.append(np.concatenate([out["route"].ravel(), out["speed_wps"].ravel()]))
        return out
    agent.run_step = capture
    rec = run.run_route(SPEC, run.model_factory(agent, **kw), max_steps=ticks,
                        on_tick=lambda w, c: controls.append(
                            (*w.ego.control, *w.ego.position, w.ego.yaw, w.ego.speed)))
    return rec, np.asarray(controls), frames, np.asarray(wps)


def _held_to_jax(j, t, ticks):
    (jrec, jctl, jframes, jwps), (trec, tctl, tframes, twps) = j, t
    assert len(tctl) == len(jctl) == len(twps) == ticks
    np.testing.assert_allclose(tctl[:, :3], jctl[:, :3], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(twps, jwps, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(tctl[:, 3:], jctl[:, 3:], atol=1e-6)
    assert all(np.array_equal(a, b) for a, b in zip(tframes, jframes))
    assert (trec["status"], trec["infractions"]) == (jrec["status"], jrec["infractions"])
    assert trec["scores"] == pytest.approx(jrec["scores"], abs=1e-6)
    assert trec["meta"]["duration_game"] == pytest.approx(ticks * 0.05)


@pytest.mark.parametrize("noise", [None, (0.5, 0.02)], ids=["plain", "gnss_noise"])
def test_model_driver_closed_loop_matches_jax(model, noise):
    """tests/test_microsim.py's closed loop (8 ticks, AgentConfig(use_cot=
    False)), through both packages; with noise, the UKF filters the ego
    state (the same draws: each world's RandomState)."""
    kw = {} if noise is None else dict(gps_noise_std=noise[0], compass_noise_std=noise[1])
    jagent, tagent = _agents(model, PLAIN, 128)
    j = _drive(jrun, jagent, 8, **kw)
    t = _drive(trun, tagent, 8, **kw)
    _held_to_jax(j, t, 8)
    assert t[0]["scores"]["score_route"] >= 0.0
    if noise is not None:
        assert tagent.ukf.initialized


def test_default_agent_closed_loop_matches_jax(model):
    """The default AgentConfig (CoT, int8 LLM, speculative after the first
    tick) in closed loop: controls, commentary and speculation rounds as
    JAX's, 4 ticks."""
    jagent, tagent = _agents(model, DEFAULT, 256)
    languages = {}
    for tag, run, agent in (("jax", jrun, jagent), ("torch", trun, tagent)):
        seen, inner = [], agent.run_step

        def step(frame, inner=inner, seen=seen, agent=agent):
            out = inner(frame)
            seen.append(agent.last_language)
            return out
        agent.run_step = step
        languages[tag] = (_drive(run, agent, 4), seen)
    (j, jlang), (t, tlang) = languages["jax"], languages["torch"]
    _held_to_jax(j, t, 4)
    assert tlang == jlang and len(tlang) == 4
    assert len(tagent.spec_stats) == 3 and tagent.spec_stats == jagent.spec_stats

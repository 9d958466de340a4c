"""The port's expert (`simlingo_tpu_torch/expert/{forecast,autopilot,scenarios}.py`)
against JAX's, on the CPU.

The modules are numpy copies. Two kinds of check:

  * JAX's own tests of them, `tests/test_expert.py` and
    `tests/test_scenarios.py`, run through the port: each test function's
    source is loaded with `simlingo_tpu.` read as `simlingo_tpu_torch.`
    (one case a JAX test, so each still counts);
  * each function of the three modules, and of `agent/lidar.py` and
    `labels/bev_renderer.py`, called by both packages on the same seeded
    inputs, with equal results: arrays bit for bit, dicts key by key. The
    expert is driven over a seeded stream of observations (vehicles,
    bicycles, walkers, lights, stop signs, lane changes, scenario results)
    that brakes, follows, overtakes and stops it, and every scenario type
    of `ScenarioManager` is driven along a route with oncoming traffic.
"""

import dataclasses
import inspect
import math
import sys

import numpy as np
import pytest

from simlingo_tpu.agent import lidar as jlidar
from simlingo_tpu.agent.controllers import LateralPIDController as JLateral
from simlingo_tpu.expert import autopilot as jap
from simlingo_tpu.expert import forecast as jfc
from simlingo_tpu.expert import route_planner as jrp
from simlingo_tpu.expert import scenarios as jsc
from simlingo_tpu.labels import bev_renderer as jbev
from simlingo_tpu_torch.agent import lidar as tlidar
from simlingo_tpu_torch.agent.controllers import LateralPIDController as TLateral
from simlingo_tpu_torch.expert import autopilot as tap
from simlingo_tpu_torch.expert import forecast as tfc
from simlingo_tpu_torch.expert import route_planner as trp
from simlingo_tpu_torch.expert import scenarios as tsc
from simlingo_tpu_torch.labels import bev_renderer as tbev
from tests.torch_ported import jax_test_names, ported_module

JAX_TESTS = ("test_expert", "test_scenarios")
_PORTED = {}


@pytest.mark.parametrize("module,test", jax_test_names(*JAX_TESTS),
                         ids=[f"{m}::{t}" for m, t in jax_test_names(*JAX_TESTS)])
def test_jax_expert_tests_through_the_port(module, test, tmp_path):
    if module not in _PORTED:
        _PORTED[module] = ported_module(module)
    fn = getattr(_PORTED[module], test)
    kwargs = {"tmp_path": tmp_path} if "tmp_path" in inspect.signature(fn).parameters \
        else {}
    fn(**kwargs)


# ---------------------------------------------------------------------------
# equal results on the same seeded inputs
# ---------------------------------------------------------------------------

def assert_same(a, b, path="out"):
    """Bit-equal arrays and floats, equal dicts key by key (same order)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _actors(rng, n, kinds=("vehicle", "bicycle", "walker")):
    out = []
    for i in range(n):
        kind = kinds[rng.randint(len(kinds))]
        a = {"position": [float(rng.uniform(-20, 45)), float(rng.uniform(-8, 8))],
             "yaw": float(rng.uniform(-math.pi, math.pi)),
             "speed": float(rng.uniform(0, 12)), "id": 100 + i,
             "steer": float(rng.uniform(-0.3, 0.3)),
             "throttle": float(rng.uniform(0, 1)), "brake": bool(rng.rand() < 0.2)}
        if kind == "walker":
            a.update(type_id="walker.pedestrian.0001", base_type="walker",
                     extent=[0.3, 0.3])
        elif kind == "bicycle":
            a.update(type_id="vehicle.bh.crossbike", base_type="bicycle",
                     extent=[0.9, 0.4])
        else:
            a.update(type_id="vehicle.lincoln.mkz", base_type="car",
                     extent=[float(rng.uniform(1.8, 3)), float(rng.uniform(0.8, 1.2))])
        out.append(a)
    return out


def _route(rng, n=600):
    """A dense ego-frame route (0.1 m) with a seeded curvature."""
    s = np.arange(n) * 0.1
    k = rng.uniform(-0.02, 0.02)
    yaw = k * s
    xy = np.stack([np.cumsum(np.cos(yaw)) * 0.1, np.cumsum(np.sin(yaw)) * 0.1], 1)
    return xy - xy[0]


@pytest.mark.parametrize("seed", range(4))
def test_obb_intersection_matches_jax(seed):
    rng = np.random.RandomState(seed)
    n = 256
    args = (rng.uniform(-5, 5, (n, 2)), rng.uniform(-4, 4, n), rng.uniform(0.2, 3, (n, 2)),
            rng.uniform(-5, 5, (n, 2)), rng.uniform(-4, 4, n), rng.uniform(0.2, 3, (n, 2)))
    a, b = jfc.obb_intersect_batch(*args), tfc.obb_intersect_batch(*args)
    assert_same(a, b)
    assert 0 < a.sum() < n                         # both outcomes occur
    for i in range(8):
        one = [x[i] for x in args]
        assert_same(jfc.obb_intersect(*one), tfc.obb_intersect(*one))


@pytest.mark.parametrize("near_lane_change", [False, True])
def test_forecasts_match_jax(near_lane_change):
    rng = np.random.RandomState(int(near_lane_change))
    actors = _actors(rng, 12) + [{"position": [80.0, 0.0], "speed": 3.0}]
    frames = jfc.ForecastConfig().num_frames(near_lane_change)
    assert frames == tfc.ForecastConfig().num_frames(near_lane_change)
    assert_same(jfc.forecast_vehicles(actors, frames, near_lane_change),
                tfc.forecast_vehicles(actors, frames, near_lane_change))
    walkers = [a for a in actors if a.get("base_type") == "walker"] + [
        {"position": [5.0, 2.0], "direction": [0.0, -1.0], "speed": 0.1}]
    assert_same(jfc.forecast_walkers(walkers, frames), tfc.forecast_walkers(walkers, frames))
    route = _route(rng)
    for speed, target in ((2.0, 8.0), (9.0, 4.0)):
        lon_j = jap.LongitudinalLinearRegressionController()
        lon_t = tap.LongitudinalLinearRegressionController()
        assert_same(jfc.forecast_ego(route, speed, target, frames, JLateral(inference_mode=False),
                                     lon_j.throttle_extrapolation),
                    tfc.forecast_ego(route, speed, target, frames, TLateral(inference_mode=False),
                                     lon_t.throttle_extrapolation))
    for a in actors:
        for yaw in (None, a.get("yaw", 0.0)):
            assert jfc.classify_route_position(route, a["position"], actor_yaw=yaw) == \
                tfc.classify_route_position(route, a["position"], actor_yaw=yaw)


def test_longitudinal_controller_matches_jax():
    j, t = jap.LongitudinalLinearRegressionController(), \
        tap.LongitudinalLinearRegressionController()
    for v in np.linspace(0, 20, 41):
        for target in np.linspace(0, 20, 41):
            for hazard in (False, True):
                assert_same(j.step(float(v), float(target), hazard),
                            t.step(float(v), float(target), hazard))
            assert_same(j.throttle_extrapolation(float(target), float(v)),
                        t.throttle_extrapolation(float(target), float(v)))


def _observations(seed, ticks):
    """A seeded stream of expert observations along one route: actors of
    every kind, lights, stop signs, lane changes and scenario results."""
    rng = np.random.RandomState(seed)
    route = _route(rng, 900)
    for t in range(ticks):
        light = [None, "red", "yellow", "green"][rng.randint(4)]
        stop = float(rng.uniform(0, 30)) if rng.rand() < 0.3 else None
        obs = dict(
            pos_global=np.array([0.5 * t, 0.01 * t]), theta=float(rng.uniform(-0.1, 0.1)),
            speed=float(rng.uniform(0, 12)), speed_limit=float(rng.choice([8.33, 13.9])),
            route=route[t % 5:], route_original=route,
            target_point=route[min(200, len(route) - 1)],
            target_point_next=route[min(600, len(route) - 1)],
            command=int(rng.randint(1, 7)), next_command=int(rng.randint(1, 7)),
            actors=_actors(rng, int(rng.randint(0, 6))),
            light_state=light, light_distance=float(rng.uniform(0, 40)) if light else None,
            stop_sign_distance=stop, stop_sign_id=int(rng.randint(3)) if stop is not None else None,
            near_lane_change=bool(rng.rand() < 0.2), junction=bool(rng.rand() < 0.2),
            changed_route=bool(rng.rand() < 0.1),
            augmentation_rotation=float(rng.uniform(-5, 5)),
            augmentation_translation=float(rng.uniform(-1, 1)))
        scen = None
        if rng.rand() < 0.3:
            scen = (float(rng.uniform(0, 10)), bool(rng.rand() < 0.5),
                    [None, "Accident", 7, float(rng.uniform(0, 30))] if rng.rand() < 0.5 else None)
        extra = {"num_lanes_same_direction": int(rng.randint(1, 4))} if rng.rand() < 0.5 else None
        yield obs, scen, extra


@pytest.mark.parametrize("seed", range(3))
def test_autopilot_ticks_match_jax(seed, tmp_path):
    """Both experts over the same stream: every output and measurement
    record equal, and the measurement files they write equal byte for byte
    once decompressed (a gzip header holds the write's clock)."""
    import gzip
    j = jap.AutoPilot(save_path=str(tmp_path / "jax"), data_save_freq=2)
    t = tap.AutoPilot(save_path=str(tmp_path / "torch"), data_save_freq=2)
    hazards = set()
    for obs, scen, extra in _observations(seed, 60):
        a = j.tick(jap.ExpertObservation(**obs), scenario_result=scen,
                   extra_measurements=extra)
        b = t.tick(tap.ExpertObservation(**obs), scenario_result=scen,
                   extra_measurements=extra)
        assert_same(a, b)
        hazards |= {k for k in ("vehicle_hazard", "walker_hazard", "light_hazard",
                                "stop_sign_hazard") if a["record"][k]}
        assert_same(j.get_brake_and_target_speed(jap.ExpertObservation(**obs)),
                    t.get_brake_and_target_speed(tap.ExpertObservation(**obs)))
    assert len(hazards) >= 3, hazards            # the stream reaches the branches
    files = sorted(p.name for p in (tmp_path / "jax" / "measurements").iterdir())
    assert len(files) == 30
    for f in files:
        assert gzip.decompress((tmp_path / "jax" / "measurements" / f).read_bytes()) == \
            gzip.decompress((tmp_path / "torch" / "measurements" / f).read_bytes())


def _scenario_records(rng):
    def actor(x, y=0.0):
        return {"position": [x, y], "extent": [float(rng.uniform(1, 2.5)), 1.0]}
    x0 = float(rng.uniform(55, 70))
    recs = [{"type": typ, "first_actor": actor(x0), "last_actor": actor(x0 + 8),
             "direction": "left" if rng.rand() < 0.5 else "right"}
            for typ in jsc.ONE_WAY_BLOCKERS + jsc.TWO_WAY_BLOCKERS]
    recs += [{"type": "InvadingTurn", "first_actor": actor(x0), "last_actor": actor(x0 + 30),
              "offset": 1.5, "direction": "left"},
             {"type": "SequentialLaneChange", "first_actor": actor(x0),
              "last_actor": actor(x0 + 12), "direction": "left"},
             {"type": "HazardAtSideLane", "first_actor": actor(x0, 1.5),
              "last_actor": actor(x0 + 6, 1.5)},
             {"type": "HazardAtSideLaneTwoWays", "first_actor": actor(x0, 1.5),
              "last_actor": actor(x0 + 6, 1.5)},
             {"type": "YieldToEmergencyVehicle", "first_actor": actor(x0 - 70),
              "direction": "right"}]
    return recs


@pytest.mark.parametrize("seed", range(2))
def test_scenario_manager_matches_jax(seed):
    """Every scenario type ScenarioManager handles, driven along a 200 m
    route with oncoming vehicles: the same (target speed, keep driving,
    reduced) each tick and the same re-planned route."""
    assert jsc.ONE_WAY_BLOCKERS == tsc.ONE_WAY_BLOCKERS
    assert jsc.TWO_WAY_BLOCKERS == tsc.TWO_WAY_BLOCKERS
    for d in (0.0, 5.0, 40.0):
        for v in (0.0, 4.0, 12.0):
            assert_same(jsc.compute_min_time_for_distance(d, 8.0, v),
                        tsc.compute_min_time_for_distance(d, 8.0, v))
    rng = np.random.RandomState(seed)
    changed = 0
    for rec in _scenario_records(rng):
        mgr = []
        for rp, sc in ((jrp, jsc), (trp, tsc)):
            p = rp.PrivilegedRoutePlanner()
            p.set_route(np.array([[0.0, 0.0], [200.0, 0.0]]))
            mgr.append((p, sc.ScenarioManager(p)))
        orng = np.random.RandomState(seed + 7)
        for x in np.arange(10.0, 120.0, 2.5):
            oncoming = [{"position": [float(x + orng.uniform(10, 60)), 3.5],
                         "speed": float(orng.uniform(0, 10))}
                        for _ in range(orng.randint(0, 3))]
            outs = []
            for p, sm in mgr:
                sm.set_active([dict(rec, first_actor=dict(rec["first_actor"]),
                                    last_actor=dict(rec.get("last_actor", rec["first_actor"])))])
                p.run_step([float(x), 0.0])
                outs.append((sm.tick(8.0, 5.0, [float(x), 0.0], oncoming),
                             p.route.copy(), p.changed_route))
            assert_same(outs[0], outs[1], rec["type"])
        changed += bool(outs[0][2])
    assert changed >= 8, changed                  # most types re-planned the route


def test_lidar_functions_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    pp, pc = rng.uniform(-5, 5, 2), rng.uniform(-5, 5, 2)
    assert_same(jlidar.relative_transform(pp, 0.3, pc, -0.2),
                tlidar.relative_transform(pp, 0.3, pc, -0.2))
    prev, cur = rng.randn(300, 4) * 10, rng.randn(280, 4) * 10
    for p in (None, prev):
        assert_same(jlidar.realign_half_sweeps(p, cur, pp, 0.3, pc, -0.2),
                    tlidar.realign_half_sweeps(p, cur, pp, 0.3, pc, -0.2))
    for s in range(4):
        assert_same(jlidar.sample_weather(np.random.RandomState(s)),
                    tlidar.sample_weather(np.random.RandomState(s)))
    assert jlidar.HAVE_LASPY == tlidar.HAVE_LASPY


def test_bev_renderers_match_jax():
    rng = np.random.RandomState(0)
    boxes = [dict(a, **{"class": "walker" if a["base_type"] == "walker" else "vehicle"})
             for a in _actors(rng, 10)]
    boxes += [{"class": "static.prop.constructioncone", "position": [12.0, 2.0],
               "yaw": 0.3, "extent": [0.5, 0.5]}]
    record = {"route": _route(rng, 400)[::10].tolist()}
    a, b = jbev.render_bev(record, boxes), tbev.render_bev(record, boxes)
    assert_same(a, b)
    assert a.any()
    assert_same(jbev.BEVRenderer().to_rgb(a), tbev.BEVRenderer().to_rgb(b))
    assert_same(jbev.tint((200, 100, 50), 0.4), tbev.tint((200, 100, 50), 0.4))
    jr, tr = jbev.ChauffeurNetRenderer(), tbev.ChauffeurNetRenderer()
    square = np.array([[-30.0, -6], [60, -6], [60, 6], [-30, 6]])
    for t in range(3):
        veh = [b for b in boxes if b["class"] == "vehicle"]
        kw = dict(vehicles=[dict(v, position=[v["position"][0] - t, v["position"][1]])
                            for v in veh],
                  walkers=[b for b in boxes if b["class"] == "walker"],
                  tl_red=[np.array([[20.0, -2], [20, 2]])],
                  stops=[{"position": [25.0, 0.0], "yaw": 0.0, "extent": [1.0, 1.5]}],
                  road_polygons=[square], lane_markings=[np.array([[-30.0, 0], [60, 0]])],
                  render_rgb=True)
        assert_same(jr.observe(**kw), tr.observe(**kw))


def test_expert_dataclasses_match_jax():
    for a, b in ((jap.ExpertObservation, tap.ExpertObservation),
                 (jfc.ForecastConfig, tfc.ForecastConfig),
                 (jsc.ScenarioConfig, tsc.ScenarioConfig)):
        fa = [(f.name, f.type) for f in dataclasses.fields(a)]
        assert fa == [(f.name, f.type) for f in dataclasses.fields(b)]
    assert_same(dataclasses.asdict(jfc.ForecastConfig()), dataclasses.asdict(tfc.ForecastConfig()))
    assert_same(dataclasses.asdict(jsc.ScenarioConfig()), dataclasses.asdict(tsc.ScenarioConfig()))
    assert jap.AutoPilot.EGO_EXTENT == tap.AutoPilot.EGO_EXTENT
    np.testing.assert_array_equal(jap.LongitudinalLinearRegressionController.PARAMS,
                                  tap.LongitudinalLinearRegressionController.PARAMS)
    assert "jax" not in sys.modules.get("simlingo_tpu_torch.expert.autopilot").__dict__

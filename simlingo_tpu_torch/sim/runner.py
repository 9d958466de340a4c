"""Microsim route runner: closed-loop evaluation.

Copy of `simlingo_tpu/sim/runner.py` without its expert driver: the
leaderboard equivalent (Bench2Drive/leaderboard/leaderboard/
leaderboard_evaluator.py + scenarios/scenario_manager.py): build the world
and scenarios from a route spec, tick the agent against it, score with the
criteria, and write a leaderboard-format result JSON that
eval/driving_score.py merges/parses.

  ModelDriver   -- the trained model (agent/agent.LingoAgent, on the GPU
                   unless it was built for the CPU) fed by the synthetic
                   camera, used for closed-loop evaluation: the microsim
                   replaces agent/carla_agent.py.

The privileged expert (`ExpertDriver`, `expert_factory`) and the data
collection it drives are not ported yet.

Route specs are plain dicts (JSON-friendly):
  {"town": "straight" | "crossing" | "curved",
   "town_kwargs": {...},
   "start_s": 5.0, "end_s": 380.0,
   "scenarios": [{"type": "Accident", "at_s": 120.0}, ...],
   "npcs": [{"at_s": 60.0, "lane": 0, "speed": 7.0}, ...],
   "route_id": "micro_0"}
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from simlingo_tpu_torch.sim import map as simmap
from simlingo_tpu_torch.sim.actors import Vehicle
from simlingo_tpu_torch.sim.camera import Camera
from simlingo_tpu_torch.sim.criteria import RouteCriteria
from simlingo_tpu_torch.sim.scenarios import ScenarioBuilder, scripted_tick
from simlingo_tpu_torch.sim.world import SimWorld

TOWNS = {
    "straight": simmap.straight_town,
    "curved": simmap.curved_town,
    "crossing": simmap.crossing_town,
    "grid": simmap.grid_town,
    "highway": simmap.highway_town,
}


def build_world(spec: Dict, seed: int = 0
                ) -> Tuple[SimWorld, np.ndarray, List[Dict]]:
    """(world with ego + scenarios spawned, sparse route, scenario recs)."""
    town = TOWNS[spec.get("town", "straight")](
        **spec.get("town_kwargs", {}))
    world = SimWorld(town, seed=seed)
    lane = town.lanes[spec.get("ego_lane", 0)]
    s0 = float(spec.get("start_s", 5.0))
    s1 = float(spec.get("end_s", lane.length - 5.0))
    turn = spec.get("turn")
    scenario_at_offset = -s0          # at_s is lane arc length by default
    if spec.get("via"):
        # multi-junction route through explicit via waypoints (grid town);
        # scenario at_s is then ROUTE arc length
        route = town.route_via(spec["via"])
        lane = town.closest_lane(route[0])
        scenario_at_offset = 0.0
    elif turn:
        if spec.get("town") != "crossing":
            raise ValueError(
                f"spec 'turn' is only meaningful on the crossing town, "
                f"got town={spec.get('town')!r}")
        if spec.get("ego_lane", 0) != 0:
            raise ValueError("turn routes start on lane 0 (eastbound); "
                             "drop 'ego_lane' or set it to 0")
        route = simmap.crossing_route(town, s0, s1, turn)
    else:
        grid = np.arange(s0, s1, 1.0)
        route = np.stack([lane.point_at_s(s) for s in grid], 0)
    ego_start = route[0]
    ego_s, _ = lane.project(ego_start)
    ego_yaw = lane.yaw_at_s(ego_s)
    if spec.get("parking_exit"):
        # ego starts in the parking lane beside the route start; drivers
        # read world.spec and arm the planner's parking-exit merge
        # (expert/route_planner.set_route parking_exit -- reference
        # privileged_route_planner.py:428-433)
        park = next((l for l in town.lanes.values()
                     if l.lane_type == "parking"), None)
        if park is None:
            raise ValueError("parking_exit route needs a parking lane "
                             "(straight town: parking_lane=True)")
        s_park, _ = park.project(ego_start)
        ego_start = park.point_at_s(s_park)
        ego_yaw = park.yaw_at_s(s_park)
    world.spawn_ego(ego_start, yaw=ego_yaw,
                    speed=float(spec.get("start_speed", 0.0)))
    world.spec = spec

    builder = ScenarioBuilder(world, route)
    records = []
    for sc in spec.get("scenarios", []):
        rec = builder.build(sc["type"],
                            float(sc["at_s"]) + scenario_at_offset,
                            **{k: v for k, v in sc.items()
                               if k not in ("type", "at_s")})
        if rec is not None:
            records.append(rec)
    for npc in spec.get("npcs", []):
        nl = town.lanes[npc.get("lane", lane.lane_id)]
        s = float(npc.get("at_s", 50.0))
        world.spawn(Vehicle(nl.point_at_s(s), yaw=nl.yaw_at_s(s),
                            speed=float(npc.get("speed", 0.0)), lane=nl,
                            target_speed=float(npc.get("target_speed",
                                                       npc.get("speed",
                                                               7.0)))))
    for flow in spec.get("flows", []):
        # an actor flow: `count` vehicles spaced `gap` m along a lane,
        # all driving at `speed` (reference srunner ActorFlow-based
        # scenarios spawn a continuous source->sink stream; a finite
        # platoon covers a MicroBench-length route)
        fl = town.lanes[flow["lane"]]
        n = int(flow.get("count", 4))
        gap = float(flow.get("gap", 24.0))
        v = float(flow.get("speed", 6.0))
        s0f = float(flow.get("from_s", 30.0))
        for k in range(n):
            s = s0f - k * gap
            if not 0.0 <= s <= fl.length:
                continue
            world.spawn(Vehicle(fl.point_at_s(s), yaw=fl.yaw_at_s(s),
                                speed=v, lane=fl, target_speed=v))
    return world, route, records


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def _set_planner_route(planner, world: SimWorld,
                       route: np.ndarray) -> None:
    """Arm the planner, honoring a parking-exit start (the route's first
    waypoint sits on the driving lane while the ego starts in the parking
    lane; the planner prepends the merge -- route_planner.set_route)."""
    spec = getattr(world, "spec", None) or {}
    if spec.get("parking_exit") and world.ego is not None:
        planner.set_route(np.asarray(route, float),
                          start_xy=world.ego.position.copy(),
                          parking_exit=True)
    else:
        planner.set_route(np.asarray(route, float))


class ModelDriver:
    """Trained-model agent closing the loop through the synthetic camera
    (microsim counterpart of agent/carla_agent.py)."""

    def __init__(self, agent, world: SimWorld, route: np.ndarray,
                 camera: Optional[Camera] = None,
                 tp_distances: Tuple[float, float] = (30.0, 60.0),
                 gps_noise_std: float = 0.0,
                 compass_noise_std: float = 0.0):
        """gps_noise_std / compass_noise_std: corrupt the ego state like
        real GNSS/IMU so the agent's UKF path (LingoAgent.filter_ego_state,
        reference agent_simlingo.py:507-529) is exercised closed-loop."""
        from simlingo_tpu_torch.expert.route_planner import PrivilegedRoutePlanner
        self.agent = agent
        self.world = world
        self.camera = camera or Camera()
        self.planner = PrivilegedRoutePlanner()
        _set_planner_route(self.planner, world, route)
        self.tp_distances = tp_distances
        self.gps_noise = gps_noise_std
        self.compass_noise = compass_noise_std

    def step(self) -> Tuple[float, float, float]:
        from simlingo_tpu_torch.agent.agent import AgentFrame
        ego, world = self.world.ego, self.world
        frames = self.camera.render(world)
        pos, yaw, speed = ego.position.copy(), float(ego.yaw), \
            float(ego.speed)
        if self.gps_noise > 0.0 or self.compass_noise > 0.0:
            pos = pos + world.rng.randn(2) * self.gps_noise
            yaw = yaw + float(world.rng.randn()) * self.compass_noise
            pos2, yaw, speed = self.agent.filter_ego_state(pos, yaw, speed)
            pos = np.asarray(pos2, float)
        inp = self.planner.ego_inputs(pos, yaw,
                                      tp_distances=self.tp_distances)
        frame = AgentFrame(rgb=frames["rgb"], speed=speed,
                           target_point=np.asarray(inp["target_point"]),
                           next_target_point=np.asarray(
                               inp["target_point_next"]),
                           compass=yaw, gps=pos)
        out = self.agent.run_step(frame)
        return (float(out["steer"]), float(out["throttle"]),
                float(out["brake"]))

    def destroy(self, record: Optional[Dict] = None) -> None:
        pass


class ReplayRecorder:
    """on_tick hook feeding the ScenarioLogger so microsim runs can be
    replay-rendered + GIF'd on infractions (agent/scenario_logger.py
    render_replay_frames / make_infraction_gifs -- the same records the
    CARLA plugin writes via SIMLINGO_RECORD_DIR)."""

    def __init__(self, save_path: str, route: np.ndarray,
                 log_every_n: int = 1):
        from simlingo_tpu_torch.agent.scenario_logger import ScenarioLogger
        self.logger = ScenarioLogger(save_path=save_path, route_index="0",
                                     log_every_n=log_every_n)
        self.logger.set_route(np.asarray(route, float))

    def __call__(self, world: SimWorld, criteria) -> None:
        ego = world.ego
        self.logger.log(
            ego.state_dict(),
            actors=[a.state_dict() for a in world.actors
                    if a is not ego and a.alive],
            lights=[l.state_dict() for l in world.lights],
            control={"steer": ego.control[0], "throttle": ego.control[1],
                     "brake": ego.control[2]})

    def dump(self, record: Optional[Dict] = None) -> Optional[str]:
        return self.logger.dump(
            infractions=record.get("infractions") if record else None)


# ---------------------------------------------------------------------------
# Route loop
# ---------------------------------------------------------------------------

def run_route(spec: Dict,
              driver_factory: Callable[[SimWorld, np.ndarray,
                                        List[Dict]], object],
              max_steps: Optional[int] = None,
              seed: int = 0,
              on_tick: Optional[Callable] = None,
              record_dir: Optional[str] = None,
              index: int = 0) -> Dict:
    """Run one route closed-loop; returns the leaderboard record.

    record_dir: write a ScenarioLogger record (records.json.gz) for
    post-hoc replay rendering / infraction GIFs."""
    seed = int(spec.get("seed", seed))      # spec-pinned seeds win
    world, route, scen_records = build_world(spec, seed=seed)
    criteria = RouteCriteria(world, route,
                             timeout=spec.get("timeout"))
    recorder = None
    if record_dir is not None:
        recorder = ReplayRecorder(
            os.path.join(record_dir, spec.get("route_id", "micro_0")),
            route)
        user_tick = on_tick

        def on_tick(w, c, _user=user_tick):
            recorder(w, c)
            if _user is not None:
                _user(w, c)
    driver = driver_factory(world, route, scen_records)
    t0 = time.time()
    steps = max_steps if max_steps is not None else int(
        criteria.timeout / world.dt) + 1
    record = None
    try:
        for _ in range(steps):
            steer, throttle, brake = driver.step()
            world.apply_ego_control(steer, throttle, brake)
            world.tick()
            scripted_tick(world)
            criteria.update()
            if on_tick is not None:
                on_tick(world, criteria)
            if criteria.finished:
                break
        scen = spec.get("scenarios") or []
        record = criteria.record(route_id=spec.get("route_id", "micro_0"),
                                 wall_time=time.time() - t0,
                                 scenario_type=(scen[0]["type"]
                                                if scen else None),
                                 index=index,
                                 weather_id=spec.get("weather_id"))
    finally:
        driver.destroy(record)
        if recorder is not None:
            recorder.dump(record)
    return record


def run_routes(specs: Sequence[Dict], driver_factory,
               out_path: Optional[str] = None, seed: int = 0,
               max_steps: Optional[int] = None,
               record_dir: Optional[str] = None) -> Dict:
    """Run many routes; write a leaderboard-format checkpoint JSON."""
    records = [run_route(s, driver_factory, seed=seed + i,
                         max_steps=max_steps, record_dir=record_dir,
                         index=i)
               for i, s in enumerate(specs)]
    checkpoint = {"_checkpoint": {"records": records}}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(checkpoint, f, indent=1)
    return checkpoint


def model_factory(agent, **kw) -> Callable:
    def make(world, route, scen_records):
        return ModelDriver(agent, world, route, **kw)
    return make

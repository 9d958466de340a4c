"""Microsim world: actors + map + the 20 Hz tick loop.

Copy of `simlingo_tpu/sim/world.py`.

Counterpart of the CARLA server's synchronous-mode tick as driven by the
leaderboard (Bench2Drive/leaderboard/leaderboard/scenarios/scenario_manager.py
_tick_scenario): advance dynamics, lights, and walkers one fixed timestep,
then let criteria and agents observe the new state. Determinism: all
randomness flows through the world's RandomState.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simlingo_tpu_torch.sim.actors import (Actor, TrafficLight, Vehicle, Walker,
                                     static_prop)
from simlingo_tpu_torch.sim.map import SimMap
from simlingo_tpu_torch.utils.geometry import obb_intersect


class SimWorld:
    """Holds the map, all actors, and steps them synchronously."""

    def __init__(self, sim_map: SimMap, dt: float = 0.05, seed: int = 0):
        self.map = sim_map
        self.dt = dt
        self.rng = np.random.RandomState(seed)
        self.time = 0.0
        self.frame = 0
        self.actors: List[Actor] = []
        # opposite approaches share a phase; crossing roads alternate
        # (spot ids 0/1 = one road, 2/3 = the crossing road)
        self.lights: List[TrafficLight] = [
            TrafficLight(spot, phase_offset=(0.0 if (spot.light_id // 2)
                                             % 2 == 0 else 12.0))
            for spot in sim_map.lights]
        self.ego: Optional[Actor] = None
        # proximity-armed light overrides: {"position", "distance",
        # "state", "fired"} -- when the ego first comes within `distance`
        # of `position`, every light's cycle is re-phased so `state` has
        # JUST begun (Vanilla*TurnEncounter{Green,Red}Light mechanics:
        # the encounter is guaranteed regardless of approach speed)
        self.light_triggers: List[Dict] = []
        # ControlLoss faults: {"position", "distance", "duration",
        # "steer_bias", "started"} -- a transient steering bias injected
        # into the ego's applied control (reference srunner
        # control_loss.py perturbs the ego's control on route triggers)
        self.control_faults: List[Dict] = []

    # -- spawning ------------------------------------------------------------
    def spawn(self, actor: Actor) -> Actor:
        self.actors.append(actor)
        return actor

    def spawn_ego(self, position, yaw=0.0, speed=0.0,
                  type_id="vehicle.lincoln.mkz_2020") -> Actor:
        self.ego = Actor(type_id=type_id, position=position, yaw=yaw,
                         speed=speed, role="ego", color="17,37,103")
        self.actors.append(self.ego)
        return self.ego

    def npcs(self) -> List[Actor]:
        return [a for a in self.actors if a.role != "ego" and a.alive]

    # -- stepping ------------------------------------------------------------
    def apply_ego_control(self, steer: float, throttle: float,
                          brake: float) -> None:
        """Integrate the ego one tick with the agent's control."""
        from simlingo_tpu_torch.agent.ukf import bicycle_model_forward
        e = self.ego
        for fault in self.control_faults:
            if fault["started"] is None and np.linalg.norm(
                    e.position - fault["position"]) < fault["distance"]:
                fault["started"] = self.time
            if fault["started"] is not None and \
                    self.time < fault["started"] + fault["duration"]:
                steer = float(np.clip(steer + fault["steer_bias"],
                                      -1.0, 1.0))
        x = np.array([e.position[0], e.position[1], e.yaw, e.speed])
        x = bicycle_model_forward(x, self.dt, float(steer), float(throttle),
                                  bool(brake > 0.5))
        e.position, e.yaw, e.speed = x[:2], float(x[2]), float(x[3])
        e.control = (float(steer), float(throttle), float(brake))

    def tick(self) -> None:
        """Advance lights, NPC vehicles, and walkers one step."""
        for light in self.lights:
            light.tick(self.dt)
        ego_pos = (self.ego.position if self.ego is not None
                   else np.zeros(2))
        for trig in self.light_triggers:
            if not trig.get("fired") and np.linalg.norm(
                    ego_pos - trig["position"]) < trig["distance"]:
                trig["fired"] = True
                ego_lane_id = (self.map.closest_lane(ego_pos).lane_id
                               if self.ego is not None else 0)
                ego_group = None
                for light in self.lights:
                    if light.spot.lane_id == ego_lane_id:
                        ego_group = (light.spot.light_id // 2) % 2
                for light in self.lights:
                    same = (ego_group is None or
                            (light.spot.light_id // 2) % 2 == ego_group)
                    state = trig["state"] if same else \
                        ("red" if trig["state"] == "green" else "green")
                    g = light.durations["green"]
                    y = light.durations["yellow"]
                    light.t = {"green": 0.0, "yellow": g,
                               "red": g + y}[state]
        for actor in self.actors:
            if not actor.alive or actor.role == "ego":
                continue
            if (isinstance(actor, Vehicle) and actor.behavior == "parked"
                    and actor.unblock_trigger_distance is not None):
                if actor._unblock_at is None and np.linalg.norm(
                        ego_pos - actor.position) \
                        < actor.unblock_trigger_distance:
                    actor._unblock_at = self.time + actor.unblock_delay
                if actor._unblock_at is not None \
                        and self.time >= actor._unblock_at:
                    actor.behavior = "drive"
            if (isinstance(actor, Vehicle)
                    and actor.brake_trigger_distance is not None
                    and np.linalg.norm(ego_pos - actor.position)
                    < actor.brake_trigger_distance):
                actor._resume_target = actor.target_speed
                actor.target_speed = 0.0
                actor._brake_resume = self.time + actor.brake_hold
                actor.brake_trigger_distance = None
            if (isinstance(actor, Vehicle)
                    and actor._brake_resume is not None
                    and self.time >= actor._brake_resume):
                actor.target_speed = actor._resume_target
                actor._brake_resume = None
            if (isinstance(actor, Vehicle)
                    and actor.cut_in_lane is not None
                    and np.linalg.norm(ego_pos - actor.position)
                    < (actor.cut_in_trigger_distance or 0.0)):
                actor.lane = actor.cut_in_lane
                actor.cut_in_lane = None
                actor.behavior = "drive"
            if isinstance(actor, Vehicle) and actor.behavior == "drive":
                lead = self._leading(actor)
                stop_at = self._stop_distance(actor)
                actor.drive_tick(self.dt, lead, stop_at)
            elif isinstance(actor, Walker):
                actor.walk_tick(self.dt, ego_pos)
        self.time += self.dt
        self.frame += 1

    def _leading(self, vehicle: Vehicle
                 ) -> Optional[Tuple[float, float, float]]:
        """Closest actor ahead within the vehicle's lane corridor."""
        if vehicle.lane is None:
            return None
        s_self, _ = vehicle.lane.project(vehicle.position)
        best = None
        for other in self.actors:
            if other is vehicle or not other.alive:
                continue
            s_o, lat_o = vehicle.lane.project(other.position)
            if abs(lat_o) > vehicle.lane.width * 0.6:
                continue
            # stationary actors parked far enough toward the lane EDGE
            # that the follower physically fits past don't stall traffic
            # (background vehicles nudge by, as CARLA's TM does) -- free
            # width check uses both OBB half-widths plus a margin so
            # followers never drive through an overlapping corner
            if other.speed < 0.1 and \
                    abs(lat_o) - other.extent[1] \
                    >= vehicle.extent[1] + 0.3:
                continue
            gap = s_o - s_self - vehicle.extent[0] - other.extent[0]
            if 0.0 < gap < 60.0 and (best is None or gap < best[0]):
                best = (gap, float(other.speed), float(other.extent[0]))
        return best

    def _stop_distance(self, vehicle: Vehicle) -> Optional[float]:
        """Distance to a red/yellow stop line governing this vehicle."""
        if vehicle.lane is None:
            return None
        s_self, _ = vehicle.lane.project(vehicle.position)
        best = None
        for light in self.lights:
            if light.spot.lane_id != vehicle.lane.lane_id:
                continue
            if light.state == "green":
                continue
            s_line, _ = vehicle.lane.project(light.spot.position)
            d = s_line - s_self - vehicle.extent[0]
            if -1.0 < d < 50.0 and (best is None or d < best):
                best = d
        return best

    # -- queries -------------------------------------------------------------
    def collisions_with_ego(self) -> List[Actor]:
        """All alive actors whose OBB intersects the ego's."""
        e = self.ego
        hits = []
        for other in self.actors:
            if other is e or not other.alive:
                continue
            if np.linalg.norm(other.position - e.position) > 8.0:
                continue
            if obb_intersect(e.position, e.yaw, e.extent,
                             other.position, other.yaw, other.extent):
                hits.append(other)
        return hits

    def light_for_lane(self, lane_id: int,
                       at_xy: Optional[np.ndarray] = None
                       ) -> Optional[TrafficLight]:
        """The lane's traffic light; with `at_xy`, the NEXT light ahead of
        that position along the lane (multi-junction towns have several
        lights per lane)."""
        matches = [l for l in self.lights if l.spot.lane_id == lane_id]
        if not matches:
            return None
        if at_xy is None:
            return matches[0]
        lane = self.map.lanes[lane_id]
        s_here, _ = lane.project(at_xy)
        best, best_d = None, None
        for light in matches:
            s_line, _ = lane.project(light.spot.position)
            d = s_line - s_here
            if d > -2.0 and (best_d is None or d < best_d):
                best, best_d = light, d
        return best

    def actor_states(self) -> List[Dict]:
        return [a.state_dict() for a in self.actors if a.alive]

    def light_states(self) -> List[Dict]:
        return [l.state_dict() for l in self.lights]

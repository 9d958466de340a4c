"""Leaderboard evaluation criteria on the microsim.

Copy of `simlingo_tpu/sim/criteria.py`.

Behavioral counterparts of the reference's atomic criteria
(Bench2Drive/scenario_runner/srunner/scenariomanager/scenarioatomics/
atomic_criteria.py): CollisionTest (:281), RunningRedLightTest (:1620),
RunningStopTest (:1799), RouteCompletionTest (:1513, 10 m / 90 %
completion thresholds), InRouteTest (:1387, 30 m deviation),
ActorBlockedTest (:417), OutsideRouteLanesTest (:984, 0.5 m shoulder
allowance) -- emitting the same infraction keys and message shapes the
statistics manager records, so eval/driving_score.py parses microsim
records and real leaderboard records identically.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from simlingo_tpu_torch.sim.world import SimWorld


class RouteCriteria:
    """All per-route criteria, updated once per world tick."""

    # atomic_criteria.py thresholds
    COMPLETION_DISTANCE = 10.0      # m to the goal counts as done
    COMPLETION_PERCENT = 90.0       # % at which goal distance applies
    DEVIATION_MAX = 30.0            # InRouteTest offroad_max
    BLOCKED_MIN_SPEED = 0.1         # m/s
    BLOCKED_MAX_TIME = 90.0         # s
    ALLOWED_OUT_DISTANCE = 0.5      # OutsideRouteLanesTest shoulder

    def __init__(self, world: SimWorld, route: np.ndarray,
                 timeout: Optional[float] = None):
        self.world = world
        self.route = np.asarray(route, float)[:, :2]
        seg = np.linalg.norm(np.diff(self.route, axis=0), axis=1)
        self._cum = np.concatenate([[0.0], np.cumsum(seg)])
        self.route_length = float(self._cum[-1])
        # generous overall budget; scenario-level timeouts are what bite
        # in practice (reference route_scenario.py:72 sets 10000 s)
        self.timeout = (timeout if timeout is not None
                        else self.route_length / 1.0 + 120.0)

        self.infractions: Dict[str, List[str]] = {
            "collisions_pedestrian": [], "collisions_vehicle": [],
            "collisions_layout": [], "red_light": [],
            "stop_infraction": [], "scenario_timeouts": [],
            "min_speed_infractions": [], "outside_route_lanes": [],
            "yield_emergency_vehicle_infractions": [],
            "route_dev": [], "vehicle_blocked": [], "route_timeout": [],
        }
        self._completion = 0.0
        self._route_idx = 0
        self._collided_with: Dict[int, float] = {}
        self._blocked_since: Optional[float] = None
        self._outside_meters = 0.0
        self._last_pos: Optional[np.ndarray] = None
        self._light_armed: Dict[int, bool] = {}
        self._stop_pending: Dict[int, bool] = {}
        self._stop_satisfied: Dict[int, bool] = {}
        # MinimumSpeedRouteTest (:1957-2083): ego vs background-traffic
        # mean speed per checkpoint (recorded, not penalized in B2D DS;
        # feeds the efficiency benchmark)
        self._minspeed_ego = 0.0
        self._minspeed_traffic = 0.0
        self._minspeed_points = 0
        self.finished: Optional[str] = None     # terminal status string

    # -- helpers -------------------------------------------------------------
    def _progress(self) -> float:
        """Route completion % via windowed closest-point projection
        (RouteCompletionTest WINDOWS_SIZE-style forward search)."""
        pos = self.world.ego.position
        hi = min(self._route_idx + 80, len(self.route))
        d = np.linalg.norm(self.route[self._route_idx:hi] - pos, axis=1)
        self._route_idx += int(np.argmin(d))
        pct = 100.0 * self._cum[self._route_idx] / max(self.route_length,
                                                       1e-9)
        goal_dist = float(np.linalg.norm(self.route[-1] - pos))
        if pct >= self.COMPLETION_PERCENT and \
                goal_dist <= self.COMPLETION_DISTANCE:
            pct = 100.0
        return pct

    # -- update --------------------------------------------------------------
    def update(self) -> None:
        if self.finished:
            return
        world, ego = self.world, self.world.ego

        self._completion = max(self._completion, self._progress())
        if self._completion >= 100.0:
            self.finished = "Completed"
            return

        # collisions (debounced per actor: one event per 2 s of contact,
        # CollisionTest ignores continued contact with the same actor)
        for other in world.collisions_with_ego():
            last = self._collided_with.get(other.actor_id, -10.0)
            if world.time - last < 2.0:
                self._collided_with[other.actor_id] = world.time
                continue
            self._collided_with[other.actor_id] = world.time
            kind = ("collisions_pedestrian" if other.base_type == "walker"
                    else "collisions_layout" if other.base_type == "static"
                    else "collisions_vehicle")
            self.infractions[kind].append(
                f"Agent collided against object with type={other.type_id} "
                f"and id={other.actor_id} at (x={other.position[0]:.3f}, "
                f"y={other.position[1]:.3f}, z=0.0) "
                f"at Frame: {world.frame}")

        # red light: ego's front axle crosses the stop line while red
        lane = world.map.closest_lane(ego.position)
        s_ego, _ = lane.project(ego.position)
        front = s_ego + ego.extent[0]
        for light in world.lights:
            if light.spot.lane_id != lane.lane_id:
                continue
            s_line, _ = lane.project(light.spot.position)
            armed = self._light_armed.get(light.spot.light_id, False)
            if front < s_line - 0.2:
                self._light_armed[light.spot.light_id] = True
            elif armed and front >= s_line:
                self._light_armed[light.spot.light_id] = False
                if light.state == "red":
                    self.infractions["red_light"].append(
                        f"Agent ran a red light {light.spot.light_id} at "
                        f"(x={light.spot.position[0]:.3f}, "
                        f"y={light.spot.position[1]:.3f}, z=0.0) "
                        f"at Frame: {world.frame}")

        # stop sign: must come (nearly) to rest inside the trigger area
        for stop in world.map.stops:
            if stop.lane_id != lane.lane_id:
                continue
            s_stop, _ = lane.project(stop.position)
            inside = abs(s_ego - s_stop) < 4.0
            sid = stop.sign_id
            if inside:
                self._stop_pending[sid] = True
                if ego.speed < 0.1:
                    self._stop_satisfied[sid] = True
            elif self._stop_pending.get(sid) and s_ego > s_stop + 4.0:
                self._stop_pending[sid] = False
                if not self._stop_satisfied.get(sid):
                    self.infractions["stop_infraction"].append(
                        f"Agent ran a stop with id={sid} at "
                        f"(x={stop.position[0]:.3f}, "
                        f"y={stop.position[1]:.3f}, z=0.0) "
                        f"at Frame: {world.frame}")

        # min-speed vs background traffic (sampled only while moving
        # background vehicles exist, MinimumSpeedRouteTest :2039-2052)
        background = [a for a in world.actors
                      if a.alive and a.role == "npc"
                      and a.base_type not in ("walker", "static")]
        if background:
            self._minspeed_traffic += sum(a.speed for a in background) \
                / len(background)
            self._minspeed_ego += ego.speed
            self._minspeed_points += 1

        # outside driving lanes (meters driven while off driving lanes)
        if self._last_pos is not None:
            step = float(np.linalg.norm(ego.position - self._last_pos))
            wp = world.map.waypoint(ego.position)
            off = (abs(wp["lateral"]) > wp["lane_width"] / 2.0
                   + self.ALLOWED_OUT_DISTANCE
                   or wp["lane_type"] not in ("driving", "parking"))
            # junction interiors have no lane assignment (OutsideRouteLanes
            # compares against junction connecting roads there; turn arcs
            # are exempt)
            if off and wp["is_junction"]:
                off = False
            if off and step > 0:
                self._outside_meters += step
        self._last_pos = ego.position.copy()

        # route deviation
        d_route = float(np.min(np.linalg.norm(
            self.route[max(self._route_idx - 40, 0):
                       self._route_idx + 120] - ego.position, axis=1)))
        if d_route > self.DEVIATION_MAX:
            self.infractions["route_dev"].append(
                f"Agent deviated from the route at (x={ego.position[0]:.3f},"
                f" y={ego.position[1]:.3f}, z=0.0) "
                f"at Frame: {world.frame}")
            self.finished = "Failed - Agent deviated from the route"
            return

        # blocked
        if ego.speed < self.BLOCKED_MIN_SPEED:
            if self._blocked_since is None:
                self._blocked_since = world.time
            elif world.time - self._blocked_since > self.BLOCKED_MAX_TIME:
                self.infractions["vehicle_blocked"].append(
                    f"Agent got blocked at (x={ego.position[0]:.3f}, "
                    f"y={ego.position[1]:.3f}, z=0.0) "
                    f"at Frame: {world.frame}")
                self.finished = "Failed - Agent got blocked"
                return
        else:
            self._blocked_since = None

        if world.time > self.timeout:
            self.infractions["route_timeout"].append(
                "Route timeout.")
            self.finished = "Failed - Agent timed out"

    # -- results -------------------------------------------------------------
    def record(self, route_id: str = "RouteScenario_0",
               town: Optional[str] = None,
               wall_time: float = 0.0,
               scenario_type: Optional[str] = None,
               index: int = 0, weather_id: Optional[str] = None,
               save_name: str = "") -> Dict:
        """Leaderboard-format route record — the exact RouteRecord schema
        the Bench2Drive statistics manager writes
        (statistics_manager.py RouteRecord + compute_route_statistics:
        status Perfect/Completed when the target is reached with 0/>0
        infractions; outside_route_lanes multiplies (1 - pct/100) per
        event; min_speed is unused in the B2D variant). Golden-pinned in
        tests/test_reference_goldens.py."""
        from simlingo_tpu_torch.eval.driving_score import _event_penalty

        infractions = dict(self.infractions)
        # min-speed checkpoint event (checkpoints=1: one per route when
        # background traffic was present; message format consumed by
        # eval/b2d_benchmarks.driving_efficiency)
        if self._minspeed_points > 0 and self._minspeed_traffic > 0:
            pct = round(100.0 * (self._minspeed_ego
                                 / self._minspeed_points)
                        / (self._minspeed_traffic
                           / self._minspeed_points), 2)
            infractions["min_speed_infractions"] = \
                list(infractions.get("min_speed_infractions", [])) + [
                    f"Average speed is {pct}% of the surrounding "
                    f"traffic's one"]
        # outside_route_lanes carries (meters, percent) in its message
        if self._outside_meters > 0.05:
            pct = 100.0 * self._outside_meters / max(self.route_length,
                                                     1e-9)
            infractions["outside_route_lanes"] = [
                f"Agent went outside its route lanes for about "
                f"{self._outside_meters:.3f} meters "
                f"({pct:.3f}% of the completed route)"]
        rc = self._completion
        penalty = 1.0
        for name, events in infractions.items():
            penalty *= _event_penalty(name, events)
        num_infractions = sum(len(v) for v in infractions.values())
        status = self.finished or "Failed - Agent timed out"
        if status == "Completed":
            # statistics_manager: target reached -> Perfect when clean
            status = "Perfect" if num_infractions == 0 else "Completed"
        return {
            "index": index,
            "route_id": route_id,
            "scenario_name": scenario_type or "RouteScenario",
            "weather_id": weather_id,
            "save_name": save_name or str(route_id),
            "town_name": town or self.world.map.name,
            "status": status,
            "num_infractions": num_infractions,
            "infractions": infractions,
            "scores": {
                "score_route": round(rc, 6),
                "score_penalty": round(penalty, 6),
                "score_composed": round(max(rc * penalty, 0.0), 6),
            },
            "meta": {
                "route_length": round(self.route_length, 3),
                "duration_game": round(self.world.time, 3),
                "duration_system": round(wall_time, 3),
                "town": town or self.world.map.name,
                # consumed by eval/b2d_benchmarks.ability_benchmark
                "scenario_type": scenario_type,
            },
        }

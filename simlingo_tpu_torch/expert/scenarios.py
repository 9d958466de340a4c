"""Scenario route management for the expert (PDM-Lite).

Copy of `simlingo_tpu/expert/scenarios.py`.

Behavioral counterpart of reference team_code/autopilot.py
`_manage_route_obstacle_scenarios` (:461-903): the data-collection expert
re-plans its route around the safety-critical scenarios Bench2Drive injects
-- static blockages (Accident / ConstructionObstacle / ParkedObstacle),
their *TwoWays variants that require overtaking through oncoming traffic,
lane-invading turns, slow hazards at the side lane, and yielding to
emergency vehicles.

The reference reads scenario internals from the patched leaderboard
(`CarlaDataProvider.active_scenarios`, SURVEY.md L1); here the same records
arrive as plain dicts (the CARLA plugin translates) so the manager is
simulator-independent and unit-testable:

    {"type": "ConstructionObstacleTwoWays",
     "first_actor": {"position": [x, y], "extent": [ex, ey], "yaw": r},
     "last_actor":  {...},
     "direction": "left"}          # side to overtake on

Everything operates on the PrivilegedRoutePlanner's global dense route.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simlingo_tpu_torch.expert.idm import IDMConfig, idm_target_speed
from simlingo_tpu_torch.expert.route_planner import PrivilegedRoutePlanner


@dataclasses.dataclass
class ScenarioConfig:
    """Behavioral constants (reference team_code/config.py:142-204,302)."""
    points_per_meter: float = 10.0
    default_max_distance_to_process: float = 50.0
    max_distance_hazard_side_lane: float = 25.0
    max_distance_hazard_side_lane_two_ways: float = 10.0
    transition_smoothness_m: float = 8.0
    transition_smoothness_construction_m: float = 10.5
    transition_length_two_ways_m: float = 4.0
    default_overtake_speed: float = 50.0 / 3.6
    overtake_speed_vehicle_opens_door: float = 40.0 / 3.6
    distance_to_delete_two_ways_m: float = 2.0
    # margins around the obstacle cluster for two-ways spans
    add_before_two_ways_m: float = -1.0
    add_after_two_ways_m: Dict = dataclasses.field(default_factory=lambda: {
        "AccidentTwoWays": 0.0, "ConstructionObstacleTwoWays": 2.5,
        "ParkedObstacleTwoWays": -0.5, "VehicleOpensDoorTwoWays": -0.5,
        # slow-moving convoy: span must cover the blockers' drift during
        # the overtake (they advance at ~2 m/s while the ego passes)
        "SequentialLaneChange": 35.0})
    # speed-profile fit used to estimate time-to-cover-distance
    # (reference compute_min_time_to_cover_distance_params)
    min_time_params: Tuple[float, ...] = (
        0.00904221, 0.00733342, -0.03744807, 0.0235038)
    fps: float = 20.0
    # IDM parameters while waiting at a two-ways blockage
    idm_two_way_s0: float = 2.0
    idm_two_way_T: float = 0.1
    lane_width: float = 3.5


ONE_WAY_BLOCKERS = ("Accident", "ConstructionObstacle", "ParkedObstacle")
TWO_WAY_BLOCKERS = ("AccidentTwoWays", "ConstructionObstacleTwoWays",
                    "ParkedObstacleTwoWays", "VehicleOpensDoorTwoWays")


def compute_min_time_for_distance(distance: float, target_speed: float,
                                  ego_speed: float,
                                  cfg: Optional[ScenarioConfig] = None
                                  ) -> float:
    """Minimum time for the ego to cover `distance`, accelerating with the
    fitted speed-change polynomial (reference :481-517)."""
    cfg = cfg or ScenarioConfig()
    p = cfg.min_time_params
    t, rem, v = 0.0, float(distance), float(ego_speed)
    dt = 1.0 / cfg.fps
    for _ in range(int(60 * cfg.fps)):          # bounded: <= 60 s simulated
        if rem - v * dt < 0:
            break
        rem -= v * dt
        t += dt
        nv = v / 120.0
        dv = max(p[0] + nv * p[1] + p[2] * nv ** 2 + p[3] * nv ** 3, 0.0)
        v = float(np.clip(120.0 * (nv + dv), 0.0, target_speed))
    return t + rem / max(v, 1e-3)


class ScenarioManager:
    """Applies active scenario records to the planner's route and adjusts
    the target speed / keep-driving decision per tick."""

    def __init__(self, planner: PrivilegedRoutePlanner,
                 cfg: Optional[ScenarioConfig] = None,
                 idm_cfg: Optional[IDMConfig] = None):
        self.planner = planner
        self.cfg = cfg or ScenarioConfig()
        self.idm_cfg = idm_cfg or IDMConfig()
        self.active: List[Dict] = []

    # -- record management -------------------------------------------------
    def set_active(self, records: Sequence[Dict]) -> None:
        """Replace the active list with fresh simulator records, keeping the
        per-record state (changed_route, span) for records already known
        (matched by type + first-actor position)."""
        def key(r):
            fa = np.asarray(r["first_actor"]["position"], float)[:2]
            return (r["type"], round(fa[0], 1), round(fa[1], 1))
        old = {key(r): r for r in self.active}
        fresh = []
        for r in records:
            prev = old.get(key(r))
            if prev is not None:
                for k in ("changed_route", "from_idx", "to_idx",
                          "path_clear"):
                    r.setdefault(k, prev.get(k))
            r.setdefault("changed_route", False)
            r.setdefault("path_clear", False)
            fresh.append(r)
        self.active = fresh

    def _span(self, rec: Dict) -> Tuple[int, int]:
        """Route-index span covering first..last actor (+ type margins)."""
        cfg = self.cfg
        first = np.asarray(rec["first_actor"]["position"], float)[:2]
        last = np.asarray(rec.get("last_actor",
                                  rec["first_actor"])["position"], float)[:2]
        i0 = self.planner.index_of(first)
        i1 = self.planner.index_of(last)
        i0, i1 = min(i0, i1), max(i0, i1)
        ppm = 1.0 / self.planner.spacing
        ext0 = float(np.asarray(rec["first_actor"].get(
            "extent", [2.5, 1.0]))[0])
        ext1 = float(np.asarray(rec.get("last_actor", rec["first_actor"]).get(
            "extent", [2.5, 1.0]))[0])
        before = cfg.add_before_two_ways_m if rec["type"] in TWO_WAY_BLOCKERS \
            else 0.0
        after = cfg.add_after_two_ways_m.get(rec["type"], 0.0)
        i0 = int(i0 - (ext0 + 1.0 - before) * ppm)
        i1 = int(i1 + (ext1 + 1.0 + after) * ppm)
        return max(i0, 0), min(max(i1, 0), len(self.planner.route) - 1)

    def _overtaking_path_clear(self, from_idx: int, to_idx: int,
                               oncoming: Sequence[Dict], ego_speed: float,
                               target_speed: float) -> bool:
        """Gap acceptance against oncoming traffic (reference :548-660):
        the ego must traverse the span before any oncoming vehicle reaches
        it."""
        dist = (to_idx - from_idx) * self.planner.spacing \
            + (from_idx - self.planner.idx) * self.planner.spacing
        t_ego = compute_min_time_for_distance(dist, target_speed, ego_speed,
                                              self.cfg)
        end = self.planner.route[min(to_idx, len(self.planner.route) - 1)]
        for v in oncoming:
            pos = np.asarray(v["position"], float)[:2]
            speed = float(v.get("speed", 0.0))
            d_v = np.linalg.norm(pos - end)
            t_v = d_v / max(speed, 1.0)
            if t_v < t_ego + 2.0:               # 2 s safety margin
                return False
        return True

    # -- per-tick ------------------------------------------------------------
    def tick(self, target_speed: float, ego_speed: float,
             ego_pos: Sequence[float],
             oncoming_vehicles: Sequence[Dict] = ()
             ) -> Tuple[float, bool, Optional[List]]:
        """Returns (target_speed, keep_driving, speed_reduced_by_obj)."""
        cfg = self.cfg
        reduced: Optional[List] = None
        keep_driving = False
        ego_pos = np.asarray(ego_pos, float)[:2]

        done = []
        for rec in self.active:
            typ = rec["type"]
            first = np.asarray(rec["first_actor"]["position"], float)[:2]
            dist_first = float(np.linalg.norm(first - ego_pos))

            if typ == "InvadingTurn":
                if dist_first < cfg.default_max_distance_to_process \
                        and not rec["changed_route"]:
                    i0, i1 = self._span(rec)
                    offset = float(rec.get("offset", 0.6 * cfg.lane_width))
                    side = -1.0 if rec.get("direction", "left") == "right" \
                        else 1.0
                    self.planner.shift_route_between(
                        i0, i1, side * offset, cfg.transition_smoothness_m)
                    rec["changed_route"] = True
                    rec["from_idx"], rec["to_idx"] = i0, i1

            elif typ in ONE_WAY_BLOCKERS:
                if dist_first < cfg.default_max_distance_to_process \
                        and not rec["changed_route"]:
                    i0, i1 = self._span(rec)
                    trans = (cfg.transition_smoothness_construction_m
                             if typ == "ConstructionObstacle"
                             else cfg.transition_smoothness_m)
                    side = 1.0 if rec.get("direction", "left") == "left" \
                        else -1.0
                    self.planner.shift_route_between(
                        i0, i1, side * cfg.lane_width, trans)
                    rec["changed_route"] = True
                    rec["from_idx"], rec["to_idx"] = i0, i1

            elif typ in TWO_WAY_BLOCKERS:
                if dist_first < cfg.default_max_distance_to_process \
                        and not rec["changed_route"]:
                    i0, i1 = self._span(rec)
                    side = 1.0 if rec.get("direction", "left") == "left" \
                        else -1.0
                    factor = float(rec.get("factor", 1.0))
                    self.planner.shift_route_between(
                        i0, i1, side * cfg.lane_width * factor,
                        cfg.transition_length_two_ways_m)
                    rec["changed_route"] = True
                    rec["from_idx"], rec["to_idx"] = i0, i1

                if rec["changed_route"]:
                    i0, i1 = rec["from_idx"], rec["to_idx"]
                    if not rec["path_clear"]:
                        rec["path_clear"] = self._overtaking_path_clear(
                            i0, i1, oncoming_vehicles, ego_speed,
                            cfg.default_overtake_speed)
                    if rec["path_clear"]:
                        # overtaking REPLACES the target speed (reference
                        # :770-776 assigns the per-type overtake speed and
                        # sets keep_driving)
                        target_speed = (
                            cfg.overtake_speed_vehicle_opens_door
                            if typ == "VehicleOpensDoorTwoWays"
                            else cfg.default_overtake_speed)
                        keep_driving = True
                    else:
                        # wait before the blockage: IDM against a stationary
                        # obstacle with the two-way parameters
                        d_stop = max((i0 - self.planner.idx)
                                     * self.planner.spacing, 0.1)
                        ts = idm_target_speed(
                            target_speed, 0.0, ego_speed, 0.0, d_stop,
                            self.idm_cfg, s0=cfg.idm_two_way_s0,
                            T=cfg.idm_two_way_T)
                        if reduced is None or reduced[0] > ts:
                            reduced = [ts, typ, rec.get("id"), d_stop]
                        target_speed = min(target_speed, ts)
                    # passed the blockage -> scenario finished
                    if self.planner.idx > i1 + int(
                            cfg.distance_to_delete_two_ways_m
                            / self.planner.spacing):
                        done.append(rec)

            elif typ == "SequentialLaneChange":
                # two consecutive lane changes around a staggered slow
                # convoy (reference sequential_lane_change.py): one
                # smooth shift of `lanes` widths across the whole span
                # (the profile's ramps land on the intermediate lane
                # mid-transition, which is exactly the sequential
                # maneuver)
                if dist_first < cfg.default_max_distance_to_process \
                        and not rec["changed_route"]:
                    i0, i1 = self._span(rec)
                    side = 1.0 if rec.get("direction", "left") == "left" \
                        else -1.0
                    lanes_n = float(rec.get("lanes", 2))
                    self.planner.shift_route_between(
                        i0, i1, side * cfg.lane_width * lanes_n,
                        2.0 * cfg.transition_smoothness_m)
                    rec["changed_route"] = True
                    rec["from_idx"], rec["to_idx"] = i0, i1

            elif typ in ("HazardAtSideLane", "HazardAtSideLaneTwoWays"):
                lim = (cfg.max_distance_hazard_side_lane_two_ways
                       if typ.endswith("TwoWays")
                       else cfg.max_distance_hazard_side_lane)
                side = 1.0 if rec.get("direction", "left") == "left" \
                    else -1.0
                if dist_first < lim and not rec["changed_route"]:
                    i0, i1 = self._span(rec)
                    self.planner.shift_route_between(
                        i0, i1, side * cfg.lane_width,
                        cfg.transition_smoothness_m)
                    rec["changed_route"] = True
                    rec["from_idx"], rec["to_idx"] = i0, i1
                elif rec["changed_route"]:
                    # the bicycles MOVE: defer the merge-back while the last
                    # one is still beside/ahead of the planned span end
                    # (reference extend_lane_shift_transition_for_hazard_at_
                    # side_lane)
                    last = rec.get("last_actor") or rec["first_actor"]
                    last_idx = self.planner.index_of(
                        np.asarray(last["position"], float)[:2])
                    margin = int(10.0 / self.planner.spacing)
                    if last_idx + margin > rec["to_idx"] \
                            and self.planner.idx \
                            > rec["to_idx"] - 2 * margin:
                        new_to = last_idx + 2 * margin
                        self.planner.extend_shift(
                            rec["to_idx"], new_to, side * cfg.lane_width,
                            cfg.transition_smoothness_m)
                        rec["to_idx"] = new_to

            elif typ == "YieldToEmergencyVehicle":
                side = 1.0 if rec.get("direction", "right") == "left" \
                    else -1.0
                if dist_first < cfg.default_max_distance_to_process \
                        and not rec["changed_route"]:
                    i0 = self.planner.idx
                    i1 = i0 + int(40.0 / self.planner.spacing)
                    self.planner.shift_route_between(
                        i0, i1, side * cfg.lane_width,
                        cfg.transition_smoothness_m)
                    rec["changed_route"] = True
                    rec["from_idx"], rec["to_idx"] = i0, i1
                # finished once the emergency vehicle is ahead of the ego
                emv = rec["first_actor"]
                rel = np.asarray(emv["position"], float)[:2] - ego_pos
                # forward = route tangent at the ego's progress index
                r, i = self.planner.route, self.planner.idx
                fwd = r[min(i + 50, len(r) - 1)] - r[max(i - 50, 0)]
                fwd = fwd / max(float(np.linalg.norm(fwd)), 1e-6)
                passed = float(rel @ fwd) > 20.0
                if rec["changed_route"] and passed:
                    done.append(rec)
                elif rec["changed_route"] and not passed \
                        and self.planner.idx > rec["to_idx"] \
                        - int(15.0 / self.planner.spacing):
                    # still being overtaken when the planned span ends:
                    # defer the merge-back (reference extend_lane_shift_
                    # transition_for_yield_to_emergency_vehicle)
                    new_to = rec["to_idx"] \
                        + int(20.0 / self.planner.spacing)
                    self.planner.extend_shift(
                        rec["to_idx"], new_to, side * cfg.lane_width,
                        cfg.transition_smoothness_m)
                    rec["to_idx"] = new_to

        for rec in done:
            self.active.remove(rec)
        return float(target_speed), keep_driving, reduced

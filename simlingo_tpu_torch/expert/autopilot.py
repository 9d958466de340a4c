"""Privileged rule-based expert (PDM-Lite core), simulator-independent.

Copy of `simlingo_tpu/expert/autopilot.py`.

Behavioral counterpart of reference `team_code/autopilot.py` (AutoPilot):

  * per-actor target speeds from kinematic forecasting + OBB intersection
    (reference get_brake_and_target_speed :1474-1741,
    compute_target_speed_wrt_leading_vehicle :1281-1350,
    compute_target_speeds_wrt_all_actors :1352-1469);
  * real stop-line distances for red lights / stop signs incl. the
    cleared-stop-sign wait logic (reference :1742-1894);
  * the fitted longitudinal linear-regression controller (reference
    team_code/longitudinal_controller.py:171-266 with the Bayesian-optimized
    parameter vector from team_code/config.py:212-219);
  * lateral PID on the dense route; measurement `save()` schema
    (reference autopilot.py:904-1010) consumed by the whole label/training
    stack.

The CARLA sensor/scenario plumbing (DataAgent) wraps this core inside the
simulator; here the core consumes an ExpertObservation so it is testable
offline and reusable for replay-based data regeneration.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from simlingo_tpu_torch.agent.controllers import LateralPIDController
from simlingo_tpu_torch.expert import forecast as F
from simlingo_tpu_torch.expert.idm import (IDM_PER_TYPE, IDMConfig,
                                     idm_target_speed)


@dataclasses.dataclass
class ExpertObservation:
    """Privileged state for one tick, already in ego coordinates."""
    pos_global: np.ndarray            # [2]
    theta: float                      # global yaw
    speed: float
    speed_limit: float
    route: np.ndarray                 # [N, 2] dense ego-frame route (0.1 m)
    route_original: np.ndarray        # [N, 2]
    target_point: np.ndarray          # [2]
    target_point_next: np.ndarray     # [2]
    command: int = 4
    next_command: int = 4
    # actors: position [2] ego-frame, speed; optional yaw, extent [2]
    # (half-sizes), steer/throttle/brake (last control), type_id, base_type,
    # id, length (legacy: 2*extent_x)
    actors: Sequence[Dict] = ()
    # traffic control state (real distances, reference :1742-1894)
    light_state: Optional[str] = None          # "red"/"yellow"/"green"/None
    light_distance: Optional[float] = None     # m to the stop line
    stop_sign_distance: Optional[float] = None # m to the trigger volume
    stop_sign_id: Optional[int] = None
    near_lane_change: bool = False
    # legacy hazard hints (still honored if no distances are provided)
    light_hazard: bool = False
    stop_sign_hazard: bool = False
    walker_hazard: bool = False
    junction: bool = False
    ego_matrix: Optional[List[List[float]]] = None
    changed_route: bool = False
    augmentation_rotation: float = 0.0
    augmentation_translation: float = 0.0


class LongitudinalLinearRegressionController:
    """Expert throttle from (speed, target_speed): the reference expert's
    default controller (team_code/longitudinal_controller.py
    LinearRegressionController) -- a polynomial feature model fitted with
    Bayesian optimization on a test track; parameter vector from
    team_code/config.py:212-216 (behavioral constants)."""

    PARAMS = np.array([
        1.1990342347353184, -0.8057602384167799, 1.710818710950062,
        0.921890257450335, 1.556497522998393, -0.7013479734904027,
        1.031266635497984,
    ])
    MIN_TARGET_SPEED = 0.278          # m/s (1 km/h)
    MAX_ACCEL = 1.89                  # km/h per tick bounds of the fit
    MAX_DECEL = -4.82

    def _features(self, speed_kmh: float, err_kmh: float) -> np.ndarray:
        e = np.clip(err_kmh, 0.0, np.inf) / 100.0
        v = speed_kmh / 100.0
        return np.array([v, v * v, 100 * e, e * e, v * e, v * v * e])

    def step(self, speed: float, target_speed: float,
             hazard_brake: bool = False) -> Tuple[float, bool]:
        """(throttle, brake) for the current tick."""
        if target_speed < 1e-5 or hazard_brake:
            return 0.0, True
        target_speed = max(target_speed, self.MIN_TARGET_SPEED)
        v, t = speed * 3.6, target_speed * 3.6
        err = t - v
        if err > self.MAX_ACCEL:
            return 1.0, False
        if v / t > self.PARAMS[-1]:
            return 0.0, True
        throttle = float(np.clip(
            self._features(v, err) @ self.PARAMS[:-1], 0.0, 1.0))
        return throttle, False

    def throttle_extrapolation(self, target_speed: float,
                               speed: float) -> float:
        """Hazard-free throttle used when forecasting the ego
        (reference get_throttle_extrapolation)."""
        v, t = speed * 3.6, target_speed * 3.6
        err = t - v
        if err > self.MAX_ACCEL:
            return 1.0
        if err < self.MAX_DECEL:
            return 0.0
        if t < 0.1 or v / t > self.PARAMS[-1]:
            return 0.0
        return float(np.clip(
            self._features(v, err) @ self.PARAMS[:-1], 0.0, 1.0))


def _is_walker(actor: Dict) -> bool:
    t = str(actor.get("type_id", "")) + str(actor.get("base_type", ""))
    return "walker" in t or "pedestrian" in t


def _is_bicycle(actor: Dict) -> bool:
    return str(actor.get("base_type", "")) == "bicycle" \
        or str(actor.get("type_id", "")).startswith("bicycle")


def _actor_extent(actor: Dict) -> np.ndarray:
    if "extent" in actor:
        return np.asarray(actor["extent"], float)[:2]
    length = float(actor.get("length", 4.5))
    return np.array([length / 2.0, 1.0])


class AutoPilot:
    EGO_EXTENT = (2.45, 0.9)          # half-sizes of the Lincoln MKZ ego

    def __init__(self, idm_cfg: Optional[IDMConfig] = None,
                 forecast_cfg: Optional[F.ForecastConfig] = None,
                 save_path: Optional[str] = None,
                 data_save_freq: int = 5,
                 num_route_points_saved: int = 50):
        self.idm_cfg = idm_cfg or IDMConfig()
        self.forecast_cfg = forecast_cfg or F.ForecastConfig()
        self.lateral = LateralPIDController(inference_mode=False)
        self.longitudinal = LongitudinalLinearRegressionController()
        self.save_path = save_path
        self.data_save_freq = data_save_freq
        self.num_route_points_saved = num_route_points_saved
        self.step_count = 0
        # stop-sign clearing state (reference :1856-1874)
        self.cleared_stop_sign = False
        self.waiting_ticks_at_stop_sign = 0
        self.clearing_distance_to_stop_sign = 3.0
        self.unclearing_distance_to_stop_sign = 10.0

    # -- target-speed decision -------------------------------------------

    def get_brake_and_target_speed(self, obs: ExpertObservation
                                   ) -> Tuple[bool, float, Optional[List]]:
        """(brake, target_speed, speed_reduced_by_obj) + hazard flags on self.

        speed_reduced_by_obj = [speed, type_id, actor_id, distance] for the
        most restrictive object (reference convention).
        """
        initial = float(obs.speed_limit)
        ego_speed = float(obs.speed)
        reduced: Optional[List] = None
        self.vehicle_hazard = False
        self.walker_hazard = False
        self.traffic_light_hazard = False
        self.stop_sign_hazard = False
        self.walker_close = False
        self.stop_sign_close = False
        self.vehicle_affecting_id = None
        self.walker_affecting_id = None

        vehicles = [a for a in obs.actors if not _is_walker(a)]
        walkers = [a for a in obs.actors if _is_walker(a)]
        num_frames = self.forecast_cfg.num_frames(obs.near_lane_change)

        pred = F.forecast_vehicles(vehicles, num_frames,
                                   obs.near_lane_change, self.forecast_cfg)
        wpred = F.forecast_walkers(walkers, num_frames, self.forecast_cfg)
        ego_fc = F.forecast_ego(
            obs.route, ego_speed, initial, num_frames,
            LateralPIDController(inference_mode=False),
            self.longitudinal.throttle_extrapolation,
            ego_extent=self.EGO_EXTENT, cfg=self.forecast_cfg)

        roles = {i: F.classify_route_position(obs.route, v["position"],
                                              actor_yaw=v.get("yaw"))
                 for i, v in enumerate(vehicles)}

        def update_reduced(speed, actor, dist):
            nonlocal reduced
            if reduced is None or reduced[0] > speed:
                reduced = [speed, actor.get("type_id", "vehicle"),
                           actor.get("id"), float(dist)]

        # 1. leading vehicle: IDM follow (reference :1281-1350)
        t_leading = initial
        for i, v in enumerate(vehicles):
            if roles[i] != "leading" or obs.near_lane_change:
                continue
            dist = float(np.linalg.norm(np.asarray(v["position"], float)[:2]))
            ext = _actor_extent(v)
            s0, T = IDM_PER_TYPE["vehicle"]
            ts = idm_target_speed(initial, 2 * ext[0], ego_speed,
                                  float(v.get("speed", 0.0)), dist,
                                  self.idm_cfg, s0=s0, T=T)
            if ts < t_leading:
                t_leading = ts
                update_reduced(ts, v, dist)

        # 2. all-actor OBB collision constraints (reference :1352-1469)
        t_vehicle = initial
        t_bicycle = initial
        for i, fc in pred.items():
            role = roles.get(i)
            if role in ("leading", "rear") and not obs.near_lane_change:
                continue
            hits = F.obb_intersect_batch(
                ego_fc["centers"], ego_fc["yaws"], ego_fc["extents"],
                fc["centers"], fc["yaws"], fc["extents"])
            if not hits.any():
                continue
            actor = vehicles[i]
            dist = float(np.linalg.norm(
                np.asarray(actor["position"], float)[:2]))
            if _is_bicycle(actor):
                s0, T = IDM_PER_TYPE["bicycle"]
                ts = idm_target_speed(initial, 2 * _actor_extent(actor)[0],
                                      ego_speed,
                                      float(actor.get("speed", 0.0)), dist,
                                      self.idm_cfg, s0=s0, T=T)
                if ts < t_bicycle:
                    t_bicycle = ts
                    update_reduced(ts, actor, dist)
            else:
                self.vehicle_hazard = True
                self.vehicle_affecting_id = actor.get("id")
                t_vehicle = 0.0
                update_reduced(0.0, actor, dist)

        # 3. walkers (reference :1437-1461)
        t_walker = initial
        for i, fc in wpred.items():
            hits = F.obb_intersect_batch(
                ego_fc["centers"], ego_fc["yaws"], ego_fc["extents"],
                fc["centers"], fc["yaws"], fc["extents"])
            if not hits.any():
                continue
            actor = walkers[i]
            dist = float(np.linalg.norm(
                np.asarray(actor["position"], float)[:2]))
            s0, T = IDM_PER_TYPE["walker"]
            ts = idm_target_speed(initial, 0.5 + self.EGO_EXTENT[0],
                                  ego_speed, 0.0, dist, self.idm_cfg,
                                  s0=s0, T=T)
            if ts < t_walker:
                t_walker = ts
                self.walker_affecting_id = actor.get("id")
                update_reduced(ts, actor, dist)

        # 4. red light at the real stop-line distance (reference :1742-1820)
        t_light = initial
        light_red = (obs.light_state in ("red", "yellow")
                     or (obs.light_state is None and obs.light_hazard))
        if light_red:
            dist = obs.light_distance if obs.light_distance is not None \
                else 8.0
            s0, T = IDM_PER_TYPE["red_light"]
            t_light = idm_target_speed(initial, 0.0, ego_speed, 0.0,
                                       float(dist), self.idm_cfg, s0=s0, T=T)
            update_reduced(t_light, {"type_id": "traffic.traffic_light"},
                           dist)

        # 5. stop sign with clearing state (reference :1821-1894)
        t_stop = initial
        stop_dist = obs.stop_sign_distance
        if stop_dist is None and obs.stop_sign_hazard:
            stop_dist = 8.0
        if stop_dist is not None:
            if stop_dist > self.unclearing_distance_to_stop_sign:
                self.cleared_stop_sign = False
                self.waiting_ticks_at_stop_sign = 0
            elif (ego_speed < 0.1
                  and stop_dist < self.clearing_distance_to_stop_sign):
                self.waiting_ticks_at_stop_sign += 1
                if self.waiting_ticks_at_stop_sign > 25:
                    self.cleared_stop_sign = True
            else:
                self.waiting_ticks_at_stop_sign = 0
            eff = np.inf if self.cleared_stop_sign else float(stop_dist)
            s0, T = IDM_PER_TYPE["stop_sign"]
            t_stop = idm_target_speed(initial, 0.0, ego_speed, 0.0, eff,
                                      self.idm_cfg, s0=s0, T=T)
            update_reduced(t_stop, {"type_id": "traffic.stop",
                                    "id": obs.stop_sign_id}, stop_dist)

        target = min(t_leading, t_bicycle, t_vehicle, t_walker, t_light,
                     t_stop)
        if target == t_walker and t_walker != initial:
            self.walker_hazard = True
            self.walker_close = True
        elif target == t_light and t_light != initial:
            self.traffic_light_hazard = True
        elif target == t_stop and t_stop != initial:
            self.stop_sign_hazard = True
            self.stop_sign_close = True
        return target == 0.0, float(target), reduced

    # -- tick --------------------------------------------------------------

    def tick(self, obs: ExpertObservation,
             scenario_result: Optional[Tuple[float, bool, Optional[List]]]
             = None,
             extra_measurements: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
        """One expert decision + (every data_save_freq steps) a measurement
        record in the reference schema.

        scenario_result: (target_speed, keep_driving, reduced) from
        ScenarioManager.tick; composed as in reference get_control
        (:388-400): while overtaking (keep_driving) the scenario speed
        REPLACES the normal decision; otherwise it caps it.
        """
        if scenario_result is not None and scenario_result[1]:
            ts_scn, _, reduced = scenario_result
            hazard_brake, target_speed = False, float(ts_scn)
            # hazard flags reset (no normal pipeline ran this tick)
            for flag in ("vehicle_hazard", "walker_hazard",
                         "traffic_light_hazard", "stop_sign_hazard",
                         "walker_close", "stop_sign_close"):
                setattr(self, flag, False)
            self.vehicle_affecting_id = None
            self.walker_affecting_id = None
        else:
            hazard_brake, target_speed, reduced = \
                self.get_brake_and_target_speed(obs)
            if scenario_result is not None:
                ts_scn, _, red_scn = scenario_result
                if ts_scn < target_speed:
                    target_speed = float(ts_scn)
                    reduced = red_scn or reduced
                    hazard_brake = hazard_brake or target_speed == 0.0
        throttle, brake = self.longitudinal.step(obs.speed, target_speed,
                                                 hazard_brake)
        steer = self.lateral.step(obs.route, obs.speed)

        record = self._measurement_record(obs, steer, throttle, brake,
                                          target_speed, reduced)
        if extra_measurements:
            # map-derived fields the offline expert cannot compute (lane
            # counts/markings, junction distance -- reference data_agent's
            # ego_info); consumed by the VQA / commentary generators
            record.update(extra_measurements)
        if (self.save_path is not None
                and self.step_count % self.data_save_freq == 0):
            frame = self.step_count // self.data_save_freq
            mdir = os.path.join(self.save_path, "measurements")
            os.makedirs(mdir, exist_ok=True)
            with gzip.open(os.path.join(mdir, f"{frame:04}.json.gz"),
                           "wt", encoding="utf-8") as f:
                json.dump(record, f)
        self.step_count += 1
        return {"steer": steer, "throttle": throttle, "brake": brake,
                "target_speed": target_speed, "record": record}

    def _measurement_record(self, obs: ExpertObservation, steer, throttle,
                            brake, target_speed, reduced) -> Dict[str, Any]:
        """The schema of reference autopilot.py:904-1010 (save())."""
        n = self.num_route_points_saved
        lim_type = reduced[1] if reduced else None
        lim_id = reduced[2] if reduced else None
        lim_dist = float(reduced[3]) if reduced else None
        ego_matrix = obs.ego_matrix
        if ego_matrix is None:
            c, s = np.cos(obs.theta), np.sin(obs.theta)
            ego_matrix = [
                [float(c), float(-s), 0.0, float(obs.pos_global[0])],
                [float(s), float(c), 0.0, float(obs.pos_global[1])],
                [0.0, 0.0, 1.0, 0.0],
                [0.0, 0.0, 0.0, 1.0]]
        return {
            "pos_global": np.asarray(obs.pos_global).tolist(),
            "theta": float(obs.theta),
            "speed": float(obs.speed),
            "target_speed": float(target_speed),
            "speed_limit": float(obs.speed_limit),
            "target_point": np.asarray(obs.target_point).tolist(),
            "target_point_next": np.asarray(obs.target_point_next).tolist(),
            "command": int(obs.command),
            "next_command": int(obs.next_command),
            "aim_wp": np.asarray(
                getattr(self.lateral, "last_aim", [0.0, 0.0])).tolist(),
            "route": np.asarray(obs.route[:n]).tolist(),
            "route_original": np.asarray(obs.route_original[:n]).tolist(),
            "changed_route": bool(obs.changed_route),
            "speed_reduced_by_obj_type": lim_type,
            "speed_reduced_by_obj_id": lim_id,
            "speed_reduced_by_obj_distance": lim_dist,
            "steer": float(steer),
            "throttle": float(throttle),
            "brake": bool(brake),
            "control_brake": bool(brake),
            "junction": bool(obs.junction),
            "vehicle_hazard": bool(self.vehicle_hazard),
            "light_hazard": bool(self.traffic_light_hazard
                                 or obs.light_hazard),
            "walker_hazard": bool(self.walker_hazard or obs.walker_hazard),
            "stop_sign_hazard": bool(self.stop_sign_hazard
                                     or obs.stop_sign_hazard),
            "stop_sign_close": bool(self.stop_sign_close),
            "walker_close": bool(self.walker_close),
            "walker_close_id": self.walker_affecting_id,
            "vehicle_affecting_id": self.vehicle_affecting_id,
            "walker_affecting_id": self.walker_affecting_id,
            "angle": 0.0,
            "augmentation_translation": float(obs.augmentation_translation),
            "augmentation_rotation": float(obs.augmentation_rotation),
            "ego_matrix": ego_matrix,
        }

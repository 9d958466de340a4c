"""Actor forecasting + oriented-bounding-box collision predicates (2D).

Copy of `simlingo_tpu/expert/forecast.py`.

Behavioral counterpart of the reference expert's collision machinery
(reference team_code/autopilot.py:1176-1741: predict_other_actors_bounding_
boxes, forecast_ego_agent, forecast_walkers; :1895-2000 check_obb_
intersection). The reference runs a 15-axis 3D separating-axis test on
upright boxes; driving geometry is planar, so the 4-axis 2D SAT here is
exact for the same inputs and an order of magnitude cheaper.

All positions/yaws are in the ego frame of the current tick (x forward,
y left/right), matching the rest of the offline expert.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simlingo_tpu_torch.agent.ukf import bicycle_model_forward


@dataclasses.dataclass
class ForecastConfig:
    """Behavioral constants of the reference expert
    (team_code/config.py:34-130)."""
    frame_rate: int = 20                      # bicycle_frame_rate
    detection_radius: float = 50.0
    default_forecast_length: float = 2.0      # seconds
    forecast_length_lane_change: float = 1.1
    min_walker_speed: float = 0.5
    pedestrian_minimum_extent: float = 1.5
    # ego bb inflation during forecasting
    extent_ego_bbs_speed_threshold: float = 5.0
    slow_speed_extent_factor_ego: float = 1.0
    high_speed_extent_factor_ego_x: float = 1.3
    high_speed_extent_factor_ego_y: float = 1.2
    # other-vehicle bb inflation
    extent_other_vehicles_bbs_speed_threshold: float = 1.0
    high_speed_min_extent_x_other_vehicle: float = 1.2
    high_speed_min_extent_x_other_vehicle_lane_change: float = 2.0
    high_speed_min_extent_y_other_vehicle: float = 1.0
    high_speed_extent_y_factor_other_vehicle: float = 1.3

    def num_frames(self, near_lane_change: bool) -> int:
        length = (self.forecast_length_lane_change if near_lane_change
                  else self.default_forecast_length)
        return int(self.frame_rate * length)


# ---------------------------------------------------------------------------
# 2D oriented-bounding-box separating-axis test
# ---------------------------------------------------------------------------

def _axes(yaw: np.ndarray) -> np.ndarray:
    """yaw [...,] -> unit forward/right axes [..., 2, 2]."""
    c, s = np.cos(yaw), np.sin(yaw)
    fwd = np.stack([c, s], axis=-1)
    right = np.stack([-s, c], axis=-1)
    return np.stack([fwd, right], axis=-2)


def obb_intersect(c1, yaw1, e1, c2, yaw2, e2) -> bool:
    """Exact 2D OBB overlap. c*: [2] centers; e*: [2] half-extents (x fwd)."""
    return bool(obb_intersect_batch(
        np.asarray(c1, float)[None], np.asarray([yaw1], float),
        np.asarray(e1, float)[None], np.asarray(c2, float)[None],
        np.asarray([yaw2], float), np.asarray(e2, float)[None])[0])


def obb_intersect_batch(c1, yaw1, e1, c2, yaw2, e2) -> np.ndarray:
    """Vectorized over a leading batch dim (e.g. future frames) -> [N] bool."""
    c1, c2 = np.asarray(c1, float), np.asarray(c2, float)
    e1, e2 = np.asarray(e1, float), np.asarray(e2, float)
    a1 = _axes(np.asarray(yaw1, float))            # [N, 2, 2]
    a2 = _axes(np.asarray(yaw2, float))
    axes = np.concatenate([a1, a2], axis=-2)       # [N, 4, 2]
    rel = (c2 - c1)[:, None, :]                    # [N, 1, 2]
    dist = np.abs((rel * axes).sum(-1))            # [N, 4]
    # projection radius of each box onto each axis
    r1 = (np.abs((a1[:, None, :, :] * axes[:, :, None, :]).sum(-1))
          * e1[:, None, :]).sum(-1)                # [N, 4]
    r2 = (np.abs((a2[:, None, :, :] * axes[:, :, None, :]).sum(-1))
          * e2[:, None, :]).sum(-1)
    return ~(dist > r1 + r2).any(axis=-1)


# ---------------------------------------------------------------------------
# Forecasting
# ---------------------------------------------------------------------------

def forecast_vehicles(actors: Sequence[Dict], num_frames: int,
                      near_lane_change: bool,
                      cfg: Optional[ForecastConfig] = None,
                      dt: Optional[float] = None
                      ) -> Dict[int, Dict[str, np.ndarray]]:
    """Kinematic-bicycle rollout of every vehicle/bicycle actor under its
    last control (reference predict_other_actors_bounding_boxes).

    actors: dicts with position [2] (ego frame), yaw, speed, extent [2]
    (half-sizes), and optional steer/throttle/brake.
    Returns {index: {centers [F,2], yaws [F], extents [F,2]}}.
    """
    cfg = cfg or ForecastConfig()
    dt = dt or 1.0 / cfg.frame_rate
    out = {}
    for idx, actor in enumerate(actors):
        pos = np.asarray(actor["position"], float)[:2]
        if np.linalg.norm(pos) > cfg.detection_radius:
            continue
        x = np.array([pos[0], pos[1], float(actor.get("yaw", 0.0)),
                      float(actor.get("speed", 0.0))])
        steer = float(actor.get("steer", 0.0))
        throttle = float(actor.get("throttle", 0.0))
        brake = bool(actor.get("brake", False))
        base_extent = np.asarray(
            actor.get("extent", [2.25, 1.0]), float)[:2]

        centers = np.zeros((num_frames, 2))
        yaws = np.zeros(num_frames)
        speeds = np.zeros(num_frames)
        for i in range(num_frames):
            x = bicycle_model_forward(x, dt, steer, throttle, brake)
            centers[i] = x[:2]
            yaws[i] = x[2]
            speeds[i] = x[3]

        # uncertainty inflation, growing with the forecast horizon
        slow = speeds < cfg.extent_other_vehicles_bbs_speed_threshold
        frac = np.arange(num_frames, dtype=float) / max(num_frames, 1)
        sx = (cfg.high_speed_min_extent_x_other_vehicle_lane_change
              if near_lane_change else cfg.high_speed_min_extent_x_other_vehicle)
        fx = np.where(slow, cfg.slow_speed_extent_factor_ego,
                      np.maximum(sx, cfg.high_speed_min_extent_x_other_vehicle
                                 * frac))
        fy = np.where(slow, cfg.slow_speed_extent_factor_ego,
                      np.maximum(cfg.high_speed_min_extent_y_other_vehicle,
                                 cfg.high_speed_extent_y_factor_other_vehicle
                                 * frac))
        extents = np.stack([base_extent[0] * fx, base_extent[1] * fy], axis=1)
        out[idx] = {"centers": centers, "yaws": yaws, "extents": extents,
                    "speeds": speeds}
    return out


def forecast_walkers(walkers: Sequence[Dict], num_frames: int,
                     cfg: Optional[ForecastConfig] = None,
                     dt: Optional[float] = None
                     ) -> Dict[int, Dict[str, np.ndarray]]:
    """Constant-velocity walker forecast (reference forecast_walkers):
    direction x speed, clamped to a minimum speed and minimum extent."""
    cfg = cfg or ForecastConfig()
    dt = dt or 1.0 / cfg.frame_rate
    out = {}
    for idx, w in enumerate(walkers):
        pos = np.asarray(w["position"], float)[:2]
        if np.linalg.norm(pos) > cfg.detection_radius:
            continue
        yaw = float(w.get("yaw", 0.0))
        direction = np.asarray(
            w.get("direction", [math.cos(yaw), math.sin(yaw)]), float)[:2]
        n = np.linalg.norm(direction)
        direction = direction / n if n > 1e-6 else np.array([1.0, 0.0])
        speed = max(float(w.get("speed", 0.0)), cfg.min_walker_speed)
        steps = np.arange(1, num_frames + 1, dtype=float)[:, None]
        centers = pos[None] + steps * direction[None] * speed * dt
        ext = np.asarray(w.get("extent", [0.5, 0.5]), float)[:2]
        ext = np.maximum(ext, cfg.pedestrian_minimum_extent)
        out[idx] = {"centers": centers,
                    "yaws": np.full(num_frames, yaw),
                    "extents": np.broadcast_to(ext, (num_frames, 2)).copy()}
    return out


def forecast_ego(route: np.ndarray, speed: float, target_speed: float,
                 num_frames: int, lateral_controller, throttle_fn,
                 ego_extent: Sequence[float] = (2.45, 0.9),
                 cfg: Optional[ForecastConfig] = None,
                 dt: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Ego rollout assuming no hazard (reference forecast_ego_agent):
    lateral PID on the (receding) dense route + regression-throttle
    extrapolation toward target_speed; bb inflated at speed.

    lateral_controller must expose step(route_ego_frame, speed) and is used
    on a copy-safe window (its integral state is saved/restored by the
    caller via a fresh instance).
    """
    cfg = cfg or ForecastConfig()
    dt = dt or 1.0 / cfg.frame_rate
    route = np.asarray(route, float)
    x = np.array([0.0, 0.0, 0.0, float(speed)])    # ego frame of tick 0
    centers = np.zeros((num_frames, 2))
    yaws = np.zeros(num_frames)

    for i in range(num_frames):
        # transform the route into the rolled-out ego pose
        c, s = math.cos(x[2]), math.sin(x[2])
        rel = route - x[:2]
        local = np.stack([c * rel[:, 0] + s * rel[:, 1],
                          -s * rel[:, 0] + c * rel[:, 1]], axis=1)
        ahead = local[local[:, 0] > 0.0]
        if len(ahead) < 2:
            ahead = local[-2:]
        steer = float(lateral_controller.step(ahead, x[3]))
        throttle = float(throttle_fn(target_speed, x[3]))
        x = bicycle_model_forward(x, dt, steer, throttle, False)
        centers[i] = x[:2]
        yaws[i] = x[2]

    if speed < cfg.extent_ego_bbs_speed_threshold:
        f = (cfg.slow_speed_extent_factor_ego,
             cfg.slow_speed_extent_factor_ego)
    else:
        f = (cfg.high_speed_extent_factor_ego_x,
             cfg.high_speed_extent_factor_ego_y)
    ext = np.array([ego_extent[0] * f[0], ego_extent[1] * f[1]])
    return {"centers": centers, "yaws": yaws,
            "extents": np.broadcast_to(ext, (num_frames, 2)).copy()}


# ---------------------------------------------------------------------------
# Route-corridor classification (leading / rear vehicles)
# ---------------------------------------------------------------------------

def classify_route_position(route: np.ndarray, actor_pos: np.ndarray,
                            lane_half_width: float = 1.75,
                            max_ahead_m: float = 80.0,
                            points_per_meter: float = 10.0,
                            actor_yaw: Optional[float] = None,
                            max_leading_yaw_deg: float = 35.0,
                            max_rear_yaw_deg: float = 30.0
                            ) -> Optional[str]:
    """'leading' if the actor sits on the ego's route corridor ahead AND is
    aligned with it, 'rear' if behind the ego on its own axis, else None.

    Reference computes this from lane topology with a yaw-alignment gate
    (privileged_route_planner.compute_leading_vehicles :806-833: route
    distance < threshold AND yaw within 35 deg of the route direction --
    so a vehicle CROSSING the future path is not mistaken for a leader;
    compute_trailing_vehicles :862-884 uses 30 deg). Without map access we
    use the dense route polyline, which is the same corridor.

    actor_yaw: actor heading relative to the ego (radians); None skips the
    alignment gate (legacy callers).
    """
    route = np.asarray(route, float)
    pos = np.asarray(actor_pos, float)[:2]
    n_ahead = min(len(route), int(max_ahead_m * points_per_meter))
    if n_ahead >= 1:
        d = np.linalg.norm(route[:n_ahead] - pos[None], axis=1)
        j = int(np.argmin(d))
        if d[j] < lane_half_width and pos[0] > 0.0:
            if actor_yaw is None:
                return "leading"
            k = min(j, n_ahead - 2)
            tang = route[k + 1] - route[k]
            route_yaw = float(np.arctan2(tang[1], tang[0]))
            diff = abs((actor_yaw - route_yaw + np.pi)
                       % (2 * np.pi) - np.pi)
            if np.degrees(diff) < max_leading_yaw_deg:
                return "leading"
            return None
    if pos[0] < 0.0 and abs(pos[1]) < lane_half_width:
        if actor_yaw is not None:
            diff = abs((actor_yaw + np.pi) % (2 * np.pi) - np.pi)
            if np.degrees(diff) >= max_rear_yaw_deg:
                return None
        return "rear"
    return None

"""Low-level controllers: longitudinal + lateral PID, waypoint -> control.

Copy of `simlingo_tpu/agent/controllers.py`.

Behavioral counterparts of:
  * windowed PID -- reference transfuser_utils.PIDController (:328-350)
  * LateralPIDController -- reference team_code/nav_planner.py:73-143
    (inference-mode lookahead over 0.1m-spaced route points)
  * control_pid -- reference team_code/agent_simlingo.py:915-962 (desired
    speed from speed-waypoint spacing x2, brake rule, PCHIP interpolation of
    the route to 0.1 m spacing)
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from simlingo_tpu_torch.agent.config import AgentConfig


class PIDController:
    """Windowed PID (error buffer of size n; I = mean, D = last diff)."""

    def __init__(self, k_p: float = 1.0, k_i: float = 0.0, k_d: float = 0.0,
                 n: int = 20):
        self.k_p, self.k_i, self.k_d = k_p, k_i, k_d
        self.n = n
        self._window: List[float] = []

    def step(self, error: float) -> float:
        self._window.append(float(error))
        self._window = self._window[-self.n:]
        if len(self._window) >= 2:
            integral = float(np.mean(self._window))
            derivative = self._window[-1] - self._window[-2]
        else:
            integral = 0.0
            derivative = 0.0
        return self.k_p * error + self.k_i * integral + self.k_d * derivative

    def reset(self):
        self._window = []


class LateralPIDController:
    """Heading-error PID over a dense (0.1 m) route, speed-scaled lookahead."""

    def __init__(self, k_p: float = 3.118357247806046,
                 k_d: float = 1.3782508892109167,
                 k_i: float = 0.6406067986034124,
                 speed_scale: float = 0.9755321901954155,
                 speed_offset: float = 1.9152884533402488,
                 n: int = 6, inference_mode: bool = True):
        self.k_p, self.k_d, self.k_i = k_p, k_d, k_i
        self.speed_scale = speed_scale
        self.speed_offset = speed_offset
        self.n = n
        self.inference_mode = inference_mode
        self._window: List[float] = []
        self.last_aim = np.zeros(2)

    def step(self, route_np: np.ndarray, current_speed: float) -> float:
        current_speed = current_speed * 3.6
        if self.inference_mode:
            n_lookahead = np.clip(
                self.speed_scale * current_speed + self.speed_offset,
                24, 105) / 10
            n_lookahead = n_lookahead - 2
            n_lookahead = int(min(n_lookahead, route_np.shape[0] - 1))
        else:
            n_lookahead = int(min(np.clip(
                self.speed_scale * current_speed + self.speed_offset,
                24, 105), route_np.shape[0] - 1))
        n_lookahead = min(n_lookahead, len(route_np) - 1)
        target = route_np[n_lookahead]
        # ego-frame aim point, exported in the measurement schema as
        # `aim_wp` (reference autopilot.py save(): ego_aim_point)
        self.last_aim = np.asarray(target[:2], float)

        yaw_path = np.arctan2(target[1], target[0])
        heading_error = yaw_path % (2 * np.pi)
        if heading_error >= np.pi:
            heading_error -= 2 * np.pi
        heading_error = heading_error * 180.0 / np.pi / 90.0

        self._window.append(heading_error)
        self._window = self._window[-self.n:]
        derivative = (0.0 if len(self._window) == 1
                      else self._window[-1] - self._window[-2])
        integral = float(np.mean(self._window))
        return float(np.clip(self.k_p * heading_error + self.k_d * derivative
                             + self.k_i * integral, -1.0, 1.0))

    def reset(self):
        self._window = []


def interpolate_waypoints(waypoints: np.ndarray) -> np.ndarray:
    """PCHIP-resample a route polyline at 0.1 m arc-length spacing
    (reference agent_simlingo.py:964-1003)."""
    from scipy.interpolate import PchipInterpolator

    waypoints = np.concatenate(
        (np.zeros_like(waypoints[:1]), np.asarray(waypoints)))
    shift = np.roll(waypoints, 1, axis=0)
    shift[0] = shift[1]
    dists = np.cumsum(np.linalg.norm(waypoints - shift, axis=1))
    dists = dists + np.arange(len(dists)) * 1e-4
    interp = PchipInterpolator(dists, waypoints, axis=0)
    x = np.arange(0.1, dists[-1], 0.1)
    pts = interp(x)
    if pts.shape[0] == 0:
        pts = waypoints[None, -1]
    return pts


class VehicleController:
    """route/speed waypoints -> (steer, throttle, brake)."""

    def __init__(self, cfg: AgentConfig):
        self.cfg = cfg
        self.speed_controller = PIDController(cfg.speed_kp, cfg.speed_ki,
                                              cfg.speed_kd, cfg.speed_n)
        self.turn_controller = LateralPIDController(inference_mode=True)

    def control_pid(self, route_waypoints: np.ndarray, speed: float,
                    speed_waypoints: np.ndarray
                    ) -> Tuple[float, float, bool]:
        cfg = self.cfg
        one_second = int(cfg.carla_fps // (cfg.wp_dilation
                                           * cfg.data_save_freq))
        half_second = one_second // 2
        desired_speed = float(np.linalg.norm(
            speed_waypoints[half_second - 2]
            - speed_waypoints[one_second - 2]) * 2.0)

        brake = (desired_speed < cfg.brake_speed
                 or (speed / max(desired_speed, 1e-9)) > cfg.brake_ratio)

        delta = float(np.clip(desired_speed - speed, 0.0, cfg.clip_delta))
        throttle = self.speed_controller.step(delta)
        throttle = float(np.clip(throttle, 0.0, cfg.clip_throttle))
        throttle = throttle if not brake else 0.0

        route_interp = interpolate_waypoints(np.asarray(route_waypoints))
        steer = self.turn_controller.step(route_interp, speed)
        steer = round(float(np.clip(steer, -1.0, 1.0)), 3)
        return steer, throttle, bool(brake)

"""Intelligent Driver Model target-speed computation + actor forecasting.

Copy of `simlingo_tpu/expert/idm.py`.

Behavioral counterpart of the PDM-Lite expert's core
(reference team_code/autopilot.py:1079-1144 `_compute_target_speed_idm` and
:1599-1741 kinematic forecasting): IDM differential equations integrated with
RK45 to the configured time bound; leading-actor constraints produce per-actor
target speeds whose minimum governs the expert.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class IDMConfig:
    # reference team_code/config.py idm_* parameters (:64-100)
    maximum_acceleration: float = 24.0
    comfortable_braking_deceleration_high_speed: float = 3.72
    comfortable_braking_deceleration_low_speed: float = 8.7
    comfortable_braking_deceleration_threshold: float = 6.02
    acceleration_exponent: float = 4.0
    t_bound: float = 0.05
    s0: float = 4.0          # minimum net distance (default)
    T: float = 0.5           # desired time headway (default)


# per-object-type (s0 minimum distance, T time headway), reference
# team_code/config.py:64-82
IDM_PER_TYPE = {
    "stop_sign": (2.0, 0.1),
    "red_light": (6.0, 0.1),
    "walker": (4.0, 0.1),
    "bicycle": (4.0, 0.25),
    "vehicle": (4.0, 0.25),
}


def idm_target_speed(desired_speed: float, leading_actor_length: float,
                     ego_speed: float, leading_actor_speed: float,
                     distance_to_leading_actor: float,
                     cfg: Optional[IDMConfig] = None,
                     s0: Optional[float] = None,
                     T: Optional[float] = None) -> float:
    """Integrate the IDM ODE for t_bound seconds; returns the end speed."""
    from scipy.integrate import RK45

    cfg = cfg or IDMConfig()
    s0 = cfg.s0 if s0 is None else s0
    T = cfg.T if T is None else T
    # inside the minimum net gap the IDM answer is "stop" -- integrating
    # there is numerically stiff (s -> 0 drives dv/dt unbounded and RK45
    # into thousands of micro-steps per call)
    if (distance_to_leading_actor - leading_actor_length
            <= max(0.5 * s0, 0.5) and leading_actor_speed < 0.5):
        return 0.0
    a = cfg.maximum_acceleration
    b = (cfg.comfortable_braking_deceleration_high_speed
         if ego_speed > cfg.comfortable_braking_deceleration_threshold
         else cfg.comfortable_braking_deceleration_low_speed)
    delta = cfg.acceleration_exponent

    def equations(t, x):
        ego_position, v = x
        # the IDM is defined for v >= 0; clamping keeps the ODE smooth
        # when a near-zero gap makes it stiff (RK45 would otherwise
        # chase an unbounded-deceleration transient with micro-steps)
        v = float(np.clip(v, 0.0, 60.0))
        speed_diff = v - leading_actor_speed
        s_star = s0 + v * T + v * speed_diff / 2.0 / math.sqrt(a * b)
        s = max(0.1, distance_to_leading_actor + t * leading_actor_speed
                - ego_position - leading_actor_length)
        dvdt = a * (1.0 - (v / max(desired_speed, 1e-6)) ** delta
                    - (s_star / s) ** 2)
        return [v, float(np.clip(dvdt, -200.0, 200.0))]

    rk45 = RK45(fun=equations, t0=0.0, y0=[0.0, ego_speed],
                t_bound=cfg.t_bound)
    # bounded integration: a stiff transient must not stall the tick
    for _ in range(256):
        if rk45.status != "running":
            break
        rk45.step()
    return float(np.clip(rk45.y[1], 0.0, np.inf))


def forecast_actor(position: np.ndarray, yaw: float, speed: float,
                   steer: float, throttle: float, brake: bool,
                   num_steps: int, dt: float = 0.05) -> np.ndarray:
    """Kinematic-bicycle rollout of another actor [num_steps, 3] (x, y, yaw)
    (reference autopilot.py:1599-1741 uses the same model per actor)."""
    from simlingo_tpu_torch.agent.ukf import bicycle_model_forward

    x = np.array([position[0], position[1], yaw, speed], float)
    out = np.zeros((num_steps, 3))
    for i in range(num_steps):
        x = bicycle_model_forward(x, dt, steer, throttle, brake)
        out[i] = (x[0], x[1], x[2])
    return out


def leading_actor_constraint(ego_speed: float, desired_speed: float,
                             actors: Sequence[Dict],
                             cfg: Optional[IDMConfig] = None
                             ) -> Tuple[float, Optional[Dict]]:
    """Min IDM target speed over forward actors within the interaction cone.

    actors: [{'position': [x, y] ego-frame, 'speed', 'length', 'type_id'}].
    Returns (target_speed, limiting_actor_or_None).
    """
    best = desired_speed
    limiting = None
    for actor in actors:
        pos = np.asarray(actor["position"], float)[:2]
        dist = float(np.linalg.norm(pos))
        # forward cone: ahead of the ego and roughly in lane
        if pos[0] <= 0.5 or abs(pos[1]) > 2.5 or dist > 40.0:
            continue
        kind = str(actor.get("type_id", "vehicle")).split(".")[0]
        s0, T = IDM_PER_TYPE.get(kind, IDM_PER_TYPE["vehicle"])
        ts = idm_target_speed(desired_speed, actor.get("length", 4.5),
                              ego_speed, actor.get("speed", 0.0), dist, cfg,
                              s0=s0, T=T)
        if ts < best:
            best = ts
            limiting = actor
    return best, limiting


def expert_target_speed(current: Dict, actors: Sequence[Dict],
                        cfg: Optional[IDMConfig] = None
                        ) -> Tuple[float, Optional[Dict]]:
    """Full expert speed decision for one frame: speed limit gated by
    red light / stop sign, then IDM-constrained by leading actors."""
    desired = float(current.get("speed_limit", 8.0))
    if current.get("light_hazard") or current.get("stop_sign_hazard"):
        # treat the stop line as a stationary actor at the recorded distance
        dist = current.get("speed_reduced_by_obj_distance") or 8.0
        kind = "red_light" if current.get("light_hazard") else "stop_sign"
        s0, T = IDM_PER_TYPE[kind]
        ts = idm_target_speed(desired, 0.0, current.get("speed", 0.0),
                              0.0, float(dist), cfg, s0=s0, T=T)
        return ts, {"type_id": "traffic_stop", "position": [dist, 0.0]}
    return leading_actor_constraint(current.get("speed", 0.0), desired,
                                    actors, cfg)

"""Microsim actors: vehicles, walkers, static props, traffic lights.

Copy of `simlingo_tpu/sim/actors.py`.

Vehicles integrate the same kinematic bicycle the UKF and the expert
forecaster use (agent/ukf.py bicycle_model_forward -- one dynamics model
across filtering, forecasting, dreaming, and simulation), with IDM
longitudinal control (expert/idm.py) and a pure-pursuit lateral controller
for NPC lane following. Traffic lights run the standard fixed-cycle state
machine (reference: CARLA traffic lights driven by scenario_runner's
RouteScenario light manager).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simlingo_tpu_torch.agent.ukf import bicycle_model_forward
from simlingo_tpu_torch.expert.idm import IDMConfig, idm_target_speed
from simlingo_tpu_torch.sim.map import Lane

_ids = itertools.count(1)


def _next_id() -> int:
    return next(_ids)


@dataclasses.dataclass
class Actor:
    """Base world object (CARLA-actor-shaped)."""
    type_id: str
    position: np.ndarray                  # [2]
    yaw: float = 0.0
    speed: float = 0.0
    extent: Tuple[float, float] = (2.45, 1.0)   # half length, half width
    color: str = "100,100,100"
    actor_id: int = dataclasses.field(default_factory=_next_id)
    role: str = "npc"                     # npc | ego | scenario | static
    base_type: str = "car"
    alive: bool = True
    # last applied control (for measurement labels)
    control: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def __post_init__(self):
        self.position = np.asarray(self.position, float)[:2].copy()

    @property
    def velocity(self) -> np.ndarray:
        return self.speed * np.array([math.cos(self.yaw),
                                      math.sin(self.yaw)])

    def corners(self) -> np.ndarray:
        """[4, 2] OBB corners, CCW."""
        ex, ey = self.extent
        local = np.array([[ex, ey], [-ex, ey], [-ex, -ey], [ex, -ey]])
        c, s = math.cos(self.yaw), math.sin(self.yaw)
        rot = np.array([[c, -s], [s, c]])
        return self.position[None] + local @ rot.T

    def state_dict(self) -> Dict:
        """ScenarioLogger / label-generator record."""
        return {"id": self.actor_id, "type": self.type_id,
                "type_id": self.type_id, "base_type": self.base_type,
                "position": [float(self.position[0]),
                             float(self.position[1]), 0.0],
                "yaw": float(self.yaw),
                "velocity": [float(self.velocity[0]),
                             float(self.velocity[1])],
                "speed": float(self.speed),
                "extent": (float(self.extent[0]), float(self.extent[1])),
                "color": self.color,
                "pitch": 0.0, "roll": 0.0}


class Vehicle(Actor):
    """NPC vehicle following a lane with IDM + pure pursuit."""

    def __init__(self, position, yaw=0.0, speed=0.0,
                 lane: Optional[Lane] = None,
                 target_speed: float = 8.0,
                 type_id: str = "vehicle.lincoln.mkz_2020",
                 behavior: str = "drive",        # drive | parked | scripted
                 **kw):
        super().__init__(type_id=type_id, position=position, yaw=yaw,
                         speed=speed, **kw)
        self.lane = lane
        self.target_speed = target_speed
        self.behavior = behavior
        self._idm = IDMConfig()
        self._wheel_base = 2.9
        # BlockedIntersection-style unblocking: a parked vehicle that
        # starts driving `unblock_delay` seconds after the ego first
        # comes within `unblock_trigger_distance`
        self.unblock_trigger_distance: Optional[float] = None
        self.unblock_delay: float = 0.0
        self._unblock_at: Optional[float] = None
        # cut-in: switch to `cut_in_lane` (pure pursuit merges) once the
        # ego is within `cut_in_trigger_distance` (HighwayCutIn /
        # StaticCutIn scenario mechanics)
        self.cut_in_lane: Optional[Lane] = None
        self.cut_in_trigger_distance: Optional[float] = None
        # HardBreakRoute mechanics: a driving lead that slams to a stop
        # once the ego closes within `brake_trigger_distance`, holds for
        # `brake_hold` seconds, then resumes (reference srunner
        # HardBreakRoute: the leading actor brakes hard on a route
        # trigger and continues after a timeout)
        self.brake_trigger_distance: Optional[float] = None
        self.brake_hold: float = 4.0
        self._brake_resume: Optional[float] = None
        self._resume_target: float = target_speed

    def drive_tick(self, dt: float, lead: Optional[Tuple[float, float,
                                                         float]],
                   stop_at: Optional[float] = None) -> None:
        """One control+dynamics tick.

        lead: (gap m, lead speed, lead half-length) of the closest same-lane
        actor ahead, None if free road. stop_at: distance to a mandatory
        stop point (red light / stop sign), treated as a standing obstacle.
        """
        if self.behavior == "parked" or not self.alive:
            self.speed = 0.0
            return
        desired = self.target_speed
        if lead is not None:
            gap, lead_speed, lead_half = lead
            desired = min(desired, idm_target_speed(
                desired, 2.0 * lead_half, self.speed, lead_speed,
                max(gap, 0.1), self._idm))
        if stop_at is not None:
            if stop_at < 1.0:
                # at (or fractionally past) the stop line: hold, don't
                # integrate the IDM into its stiff near-zero-gap regime
                desired = 0.0
            else:
                desired = min(desired, idm_target_speed(
                    desired, 0.0, self.speed, 0.0, stop_at,
                    self._idm, s0=2.0, T=0.1))
        # longitudinal: simple proportional throttle/brake to the IDM speed
        err = desired - self.speed
        throttle = float(np.clip(err * 0.8, 0.0, 0.75))
        brake = err < -0.6 or desired < 0.15
        # lateral: pure pursuit on the lane centerline
        steer = 0.0
        if self.lane is not None:
            s, _ = self.lane.project(self.position)
            look = max(2.0, 1.2 * self.speed)
            target = self.lane.point_at_s(s + look)
            rel = target - self.position
            c, si = math.cos(self.yaw), math.sin(self.yaw)
            local = np.array([c * rel[0] + si * rel[1],
                              -si * rel[0] + c * rel[1]])
            alpha = math.atan2(local[1], max(local[0], 1e-3))
            steer = float(np.clip(
                math.atan2(2.0 * self._wheel_base * math.sin(alpha), look)
                / 1.22, -1.0, 1.0))
        x = np.array([self.position[0], self.position[1], self.yaw,
                      self.speed])
        x = bicycle_model_forward(x, dt, steer, throttle, bool(brake))
        self.position, self.yaw, self.speed = x[:2], float(x[2]), float(x[3])
        self.control = (steer, throttle, 1.0 if brake else 0.0)


class Walker(Actor):
    """Pedestrian: stands until triggered, then walks its path."""

    def __init__(self, position, path: Optional[np.ndarray] = None,
                 walk_speed: float = 1.4,
                 trigger_distance: Optional[float] = None,
                 type_id: str = "walker.pedestrian.0001", **kw):
        kw.setdefault("extent", (0.35, 0.35))
        kw.setdefault("base_type", "walker")
        super().__init__(type_id=type_id, position=position, **kw)
        self.path = (np.asarray(path, float)
                     if path is not None else None)
        self.walk_speed = walk_speed
        self.trigger_distance = trigger_distance
        self.triggered = trigger_distance is None
        self._path_i = 0

    def walk_tick(self, dt: float, ego_position: np.ndarray) -> None:
        if not self.alive:
            return
        if not self.triggered:
            if (self.trigger_distance is not None and
                    np.linalg.norm(ego_position - self.position)
                    < self.trigger_distance):
                self.triggered = True
            else:
                self.speed = 0.0
                return
        if self.path is None or self._path_i >= len(self.path):
            self.speed = 0.0
            return
        target = self.path[self._path_i]
        rel = target - self.position
        dist = float(np.linalg.norm(rel))
        if dist < 0.3:
            self._path_i += 1
            return
        self.yaw = math.atan2(rel[1], rel[0])
        step = min(self.walk_speed * dt, dist)
        self.position = self.position + rel / dist * step
        self.speed = self.walk_speed


def static_prop(position, yaw=0.0, type_id="static.prop.trafficcone01",
                extent=(0.4, 0.4), **kw) -> Actor:
    kw.setdefault("base_type", "static")
    kw.setdefault("role", "static")
    return Actor(type_id=type_id, position=position, yaw=yaw,
                 extent=extent, **kw)


class TrafficLight:
    """Fixed-cycle light bound to a map TrafficLightSpot.

    phase_offset staggers approaches so crossing roads alternate
    (reference: CARLA light groups).
    """

    STATES = ("green", "yellow", "red")

    def __init__(self, spot, green: float = 10.0, yellow: float = 2.0,
                 red: float = 12.0, phase_offset: float = 0.0,
                 frozen: Optional[str] = None):
        self.spot = spot
        self.durations = {"green": green, "yellow": yellow, "red": red}
        self.cycle = green + yellow + red
        self.t = phase_offset % self.cycle
        self.frozen = frozen

    @property
    def state(self) -> str:
        if self.frozen:
            return self.frozen
        t = self.t
        if t < self.durations["green"]:
            return "green"
        if t < self.durations["green"] + self.durations["yellow"]:
            return "yellow"
        return "red"

    def tick(self, dt: float) -> None:
        self.t = (self.t + dt) % self.cycle

    def state_dict(self) -> Dict:
        return {"id": int(self.spot.light_id),
                "position": [float(self.spot.position[0]),
                             float(self.spot.position[1])],
                "yaw": float(self.spot.yaw),
                "state": {"red": 0, "yellow": 1, "green": 2}[self.state],
                "extent": (1.5, 6.0)}

"""Route planning: GPS conversion + target-point extraction.

Copy of `simlingo_tpu/agent/route_planner.py` (numpy only).

Behavioral counterpart of reference `team_code/nav_planner.py:180-298`
(RoutePlanner): mercator GPS->CARLA conversion with lat/lon reference,
sliding route window, ego-frame target points for the prompt.
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

EARTH_RADIUS_EQUA = 6378137.0


def inverse_conversion_2d(point: np.ndarray, translation: np.ndarray,
                          yaw: float) -> np.ndarray:
    """Global 2D point -> ego frame (reference transfuser_utils:132-156)."""
    rot = np.array([[np.cos(yaw), -np.sin(yaw)],
                    [np.sin(yaw), np.cos(yaw)]])
    return rot.T @ (point - translation)


class CarlaRoutePlanner:
    def __init__(self, min_distance: float = 7.5, max_distance: float = 50.0,
                 lat_ref: float = 0.0, lon_ref: float = 0.0):
        self.route: deque = deque()
        self.route_distances: deque = deque()
        self.min_distance = min_distance
        self.max_distance = max_distance
        self.lat_ref = lat_ref
        self.lon_ref = lon_ref
        self.is_last = False

    def convert_gps_to_carla(self, gps) -> np.ndarray:
        lat, lon, z = gps
        scale = math.cos(self.lat_ref * math.pi / 180.0)
        my = math.log(math.tan((lat + 90) * math.pi / 360.0)) \
            * (EARTH_RADIUS_EQUA * scale)
        mx = (lon * (math.pi * EARTH_RADIUS_EQUA * scale)) / 180.0
        y = scale * EARTH_RADIUS_EQUA * math.log(
            math.tan((90.0 + self.lat_ref) * math.pi / 360.0)) - my
        x = mx - scale * self.lon_ref * math.pi * EARTH_RADIUS_EQUA / 180.0
        return np.array([x, y, z])

    def set_route(self, global_plan_world_coord) -> None:
        """global_plan: [(transform_or_xyz, command)]."""
        self.route.clear()
        self.route_distances.clear()
        for pos, cmd in global_plan_world_coord:
            if hasattr(pos, "location"):
                p = np.array([pos.location.x, pos.location.y, pos.location.z])
            else:
                p = np.asarray(pos, float)
            self.route.append((p, cmd))
        self.route_distances.append(0.0)
        for i in range(1, len(self.route)):
            d = self.route[i][0][:2] - self.route[i - 1][0][:2]
            self.route_distances.append(float(np.linalg.norm(d)))

    def run_step(self, pos: np.ndarray) -> deque:
        """Pop passed waypoints (reference nav_planner.py:258-278)."""
        if len(self.route) <= 2:
            self.is_last = True
            return self.route
        to_pop = 0
        farthest_in_range = -np.inf
        cumulative = 0.0
        for i in range(1, len(self.route)):
            if cumulative > self.max_distance:
                break
            cumulative += self.route_distances[i]
            d = float(np.linalg.norm(self.route[i][0][:2] - pos[:2]))
            if farthest_in_range < d <= self.min_distance:
                farthest_in_range = d
                to_pop = i
        for _ in range(to_pop):
            if len(self.route) > 2:
                self.route.popleft()
                self.route_distances.popleft()
        return self.route

    def target_points(self, pos: np.ndarray, yaw: float
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Ego-frame current + next target points for the prompt."""
        route = self.run_step(pos)
        tp_global = route[1][0][:2] if len(route) > 1 else route[0][0][:2]
        tp_next_global = route[2][0][:2] if len(route) > 2 else tp_global
        tp = inverse_conversion_2d(tp_global, pos[:2], yaw)
        tp_next = inverse_conversion_2d(tp_next_global, pos[:2], yaw)
        return tp, tp_next

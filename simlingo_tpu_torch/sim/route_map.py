"""MicrosimRouteMap: back labels/route_tools' injectable map protocol with
the in-repo SimMap -- the route split/balance tooling (reference
split_route_files.py / balance_scenarios.py need a live CARLA server for
these queries) runs fully in-repo against microsim towns.

Copy of `simlingo_tpu/sim/route_map.py`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from simlingo_tpu_torch.labels.route_tools import RouteMap
from simlingo_tpu_torch.sim.map import SimMap


class MicrosimRouteMap(RouteMap):
    """Map queries answered from a SimMap's lane polylines."""

    def __init__(self, sim_map: SimMap, resolution: float = 1.0):
        self.map = sim_map
        self.resolution = resolution

    def trace_route(self, a: Sequence[float], b: Sequence[float]
                    ) -> List[Tuple[List[float], str]]:
        # ParsedRoute.build_trace mixes these with the route file's 3D
        # waypoints into one [T, 3] array -- points must be [x, y, z]
        pts = self.map.route_between(a, b, spacing=self.resolution)
        return [([float(p[0]), float(p[1]), 0.0], "LANEFOLLOW")
                for p in pts]

    def is_junction(self, p: Sequence[float]) -> bool:
        return self.map.in_junction(p)

    def junction_has_traffic_lights(self, p: Sequence[float]) -> bool:
        if not self.map.in_junction(p):
            return False
        p = np.asarray(p, float)[:2]
        return any(np.linalg.norm(np.asarray(l.position) - p) < 30.0
                   for l in self.map.lights)

    def lane_change(self, p: Sequence[float]) -> str:
        lane = self.map.closest_lane(p)
        left = lane.lane_change_left and lane.left is not None
        right = lane.lane_change_right and lane.right is not None
        if left and right:
            return "Both"
        if left:
            return "Left"
        if right:
            return "Right"
        return "NONE"

    def same_dir_lane_points(self, p: Sequence[float]) -> List[List[float]]:
        lane = self.map.closest_lane(p)
        s, _ = lane.project(p)

        def xyz(lane_, s_):
            q = lane_.point_at_s(s_)
            return [float(q[0]), float(q[1]), 0.0]

        out = [xyz(lane, s)]
        for side in ("left", "right"):
            probe = lane
            while True:
                nxt = self.map.neighbor(probe, side)
                if nxt is None or nxt.lane_type != "driving":
                    break
                ss, _ = nxt.project(p)
                out.append(xyz(nxt, ss))
                probe = nxt
        return out

"""Lane-polyline HD map for the microsim.

Copy of `simlingo_tpu/sim/map.py`.

The map model is the minimum the framework's consumers need (expert route
planning, NPC lane following, criteria lane checks, camera rendering, VQA
road-layout context): roads made of parallel directed lanes, each lane a
centerline polyline at ~1 m spacing with width, direction, marking types,
and neighbor links. Junctions are convex polygons connecting road ends.

Reference counterpart: the CARLA OpenDRIVE map accessed through
carla.Map.get_waypoint / Waypoint.next / get_left_lane / get_right_lane
(used all over team_code/ and dataset_generation/); here the same queries
are answered from numpy polylines.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Lane:
    """One directed lane: centerline [N, 2] at ~1 m spacing."""
    lane_id: int
    center: np.ndarray                    # [N, 2] float
    width: float = 3.5
    # neighbor lane ids (same direction travel possible), None = none
    left: Optional[int] = None            # lane to the left (driving dir)
    right: Optional[int] = None
    # opposite-direction neighbor (for TwoWays overtaking)
    opposite: Optional[int] = None
    lane_change_left: bool = True         # marking permits change
    lane_change_right: bool = True
    lane_type: str = "driving"            # driving | parking | shoulder | bidirectional
    marking_left: str = "Broken"          # reference lane-marking names
    marking_right: str = "Solid"
    marking_left_color: str = "White"
    marking_right_color: str = "White"
    speed_limit: float = 13.89            # m/s (50 km/h default)
    is_junction: bool = False
    road_id: int = 0

    def __post_init__(self):
        self.center = np.asarray(self.center, float)[:, :2]
        seg = np.linalg.norm(np.diff(self.center, axis=0), axis=1)
        self._cum = np.concatenate([[0.0], np.cumsum(seg)])

    @property
    def length(self) -> float:
        return float(self._cum[-1])

    def index_at_s(self, s: float) -> int:
        return int(np.searchsorted(self._cum, min(max(s, 0.0),
                                                  self.length)))

    def point_at_s(self, s: float) -> np.ndarray:
        s = min(max(s, 0.0), self.length)
        return np.stack([np.interp(s, self._cum, self.center[:, 0]),
                         np.interp(s, self._cum, self.center[:, 1])])

    def yaw_at_s(self, s: float) -> float:
        i = min(self.index_at_s(s), len(self.center) - 2)
        d = self.center[i + 1] - self.center[i]
        return math.atan2(d[1], d[0])

    def project(self, xy: Sequence[float]) -> Tuple[float, float]:
        """(arc length s, signed lateral offset; +left of centerline)."""
        p = np.asarray(xy, float)[:2]
        d = np.linalg.norm(self.center - p, axis=1)
        i = int(np.argmin(d))
        j = min(i, len(self.center) - 2)
        t = self.center[j + 1] - self.center[j]
        tn = t / max(np.linalg.norm(t), 1e-9)
        rel = p - self.center[j]
        s = self._cum[j] + float(np.clip(np.dot(rel, tn), 0.0,
                                         np.linalg.norm(t)))
        lat = float(tn[0] * rel[1] - tn[1] * rel[0])
        return s, lat


@dataclasses.dataclass
class Road:
    """Parallel lanes, ordered left -> right seen in lanes[0]'s direction."""
    road_id: int
    lanes: List[Lane]


@dataclasses.dataclass
class TrafficLightSpot:
    """Map-anchored light: stop line at `position` on `lane_id`."""
    light_id: int
    lane_id: int
    position: np.ndarray                  # [2] stop line center
    yaw: float                            # lane direction at the stop line


@dataclasses.dataclass
class StopSignSpot:
    sign_id: int
    lane_id: int
    position: np.ndarray
    yaw: float
    trigger_extent: Tuple[float, float] = (1.5, 1.5)


class SimMap:
    """Queryable map: lanes by id + spatial closest-lane lookup."""

    def __init__(self, roads: Sequence[Road],
                 junctions: Sequence[np.ndarray] = (),
                 lights: Sequence[TrafficLightSpot] = (),
                 stops: Sequence[StopSignSpot] = (),
                 name: str = "MicroTown"):
        self.name = name
        self.roads = list(roads)
        self.lanes: Dict[int, Lane] = {}
        for road in self.roads:
            for lane in road.lanes:
                lane.road_id = road.road_id
                self.lanes[lane.lane_id] = lane
        self.junctions = [np.asarray(j, float) for j in junctions]
        self.lights = list(lights)
        self.stops = list(stops)
        # flat spatial index: (lane_id, point_idx) rows + [M, 2] points
        ids, pts = [], []
        for lane in self.lanes.values():
            ids.extend((lane.lane_id, i) for i in range(len(lane.center)))
            pts.append(lane.center)
        self._index_ids = ids
        self._index_pts = (np.concatenate(pts, 0) if pts
                           else np.zeros((0, 2)))

    # -- queries -----------------------------------------------------------
    def closest_lane(self, xy: Sequence[float],
                     driving_only: bool = True) -> Lane:
        p = np.asarray(xy, float)[:2]
        d = np.linalg.norm(self._index_pts - p, axis=1)
        order = np.argsort(d)
        for k in order[:64]:
            lane = self.lanes[self._index_ids[int(k)][0]]
            if not driving_only or lane.lane_type == "driving":
                return lane
        return self.lanes[self._index_ids[int(order[0])][0]]

    def waypoint(self, xy: Sequence[float]) -> Dict:
        """CARLA-get_waypoint-shaped dict for label generators/criteria."""
        lane = self.closest_lane(xy, driving_only=False)
        s, lat = lane.project(xy)
        return {
            "lane_id": lane.lane_id, "road_id": lane.road_id,
            "s": s, "lateral": lat, "lane_width": lane.width,
            "is_junction": lane.is_junction or self.in_junction(xy),
            "lane_type": lane.lane_type,
            "yaw": lane.yaw_at_s(s),
            "speed_limit": lane.speed_limit,
        }

    def route_via(self, points: Sequence[Sequence[float]],
                  spacing: float = 1.0) -> np.ndarray:
        """Chain route_between over via points (multi-turn routes across
        several junctions)."""
        pts = [np.asarray(p, float)[:2] for p in points]
        if len(pts) < 2:
            raise ValueError(
                f"route_via needs at least 2 via points, got {len(pts)}")
        legs = [self.route_between(pts[i], pts[i + 1], spacing)
                for i in range(len(pts) - 1)]
        out = [legs[0]]
        for leg in legs[1:]:
            out.append(leg[1:] if len(leg) > 1 else leg)
        return np.concatenate(out, 0)

    def in_junction(self, xy: Sequence[float]) -> bool:
        p = np.asarray(xy, float)[:2]
        for poly in self.junctions:
            if _point_in_polygon(p, poly):
                return True
        return False

    def neighbor(self, lane: Lane, side: str) -> Optional[Lane]:
        nid = lane.left if side == "left" else lane.right
        return self.lanes.get(nid) if nid is not None else None

    def route_between(self, start_xy: Sequence[float],
                      end_xy: Sequence[float],
                      spacing: float = 1.0) -> np.ndarray:
        """Sparse route along lane centerlines between two points.

        Same-lane endpoints follow the centerline; endpoints on DIFFERENT
        lanes are joined through a tangent-matched Hermite connector cut in
        at the lanes' closest approach (the microsim's stand-in for an
        OpenDRIVE junction connecting road) -- so junction turns trace
        correctly. The planner densifies downstream
        (expert/route_planner.densify_route).
        """
        lane_a = self.closest_lane(start_xy)
        lane_b = self.closest_lane(end_xy)
        s0, _ = lane_a.project(start_xy)
        if lane_a is lane_b:
            s1, _ = lane_a.project(end_xy)
            grid = np.arange(s0, max(s1, s0 + spacing), spacing)
            return np.stack([lane_a.point_at_s(s) for s in grid], 0)
        # closest-approach pair of the two centerlines (coarse stride)
        ca, cb = lane_a.center[::4], lane_b.center[::4]
        d = np.linalg.norm(ca[:, None] - cb[None, :], axis=2)
        ia, ib = np.unravel_index(int(np.argmin(d)), d.shape)
        margin = 8.0
        s_cut_a = max(float(lane_a._cum[ia * 4]) - margin, s0 + spacing)
        s_cut_b = min(float(lane_b._cum[ib * 4]) + margin,
                      lane_b.project(end_xy)[0] - spacing)
        pts = [lane_a.point_at_s(s)
               for s in np.arange(s0, s_cut_a, spacing)]
        # tangent-matched cubic Hermite across the junction
        pa, pb = lane_a.point_at_s(s_cut_a), lane_b.point_at_s(s_cut_b)
        ya, yb = lane_a.yaw_at_s(s_cut_a), lane_b.yaw_at_s(s_cut_b)
        scale = float(np.linalg.norm(pb - pa))
        ta = scale * np.array([math.cos(ya), math.sin(ya)])
        tb = scale * np.array([math.cos(yb), math.sin(yb)])
        n = max(int(1.5 * scale / spacing), 4)
        for t in np.linspace(0.0, 1.0, n + 1)[1:]:
            h00 = 2 * t ** 3 - 3 * t ** 2 + 1
            h10 = t ** 3 - 2 * t ** 2 + t
            h01 = -2 * t ** 3 + 3 * t ** 2
            h11 = t ** 3 - t ** 2
            pts.append(h00 * pa + h10 * ta + h01 * pb + h11 * tb)
        s_end, _ = lane_b.project(end_xy)
        pts.extend(lane_b.point_at_s(s)
                   for s in np.arange(s_cut_b + spacing, s_end, spacing))
        return np.asarray(pts, float)


def _point_in_polygon(p: np.ndarray, poly: np.ndarray) -> bool:
    x, y = p
    inside = False
    n = len(poly)
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        if (y1 > y) != (y2 > y):
            xin = x1 + (y - y1) / (y2 - y1) * (x2 - x1)
            if x < xin:
                inside = not inside
    return inside


# ---------------------------------------------------------------------------
# Town builders
# ---------------------------------------------------------------------------

def _straight(p0, p1, n=None) -> np.ndarray:
    p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
    if n is None:
        n = max(int(np.linalg.norm(p1 - p0)) + 1, 2)
    t = np.linspace(0.0, 1.0, n)[:, None]
    return p0[None] * (1 - t) + p1[None] * t


def straight_town(length: float = 400.0, lanes_per_dir: int = 2,
                  lane_width: float = 3.5,
                  parking_lane: bool = False,
                  speed_limit: float = 13.89) -> SimMap:
    """Two-way straight road along +x; ego lanes at y<0 (right-hand)."""
    lanes: List[Lane] = []
    lid = 0
    # forward (+x) lanes: index 0 = leftmost of the direction
    for i in range(lanes_per_dir):
        y = -(i + 0.5) * lane_width
        lanes.append(Lane(lid, _straight([0, y], [length, y]),
                          width=lane_width, speed_limit=speed_limit))
        lid += 1
    # backward (-x) lanes
    for i in range(lanes_per_dir):
        y = (i + 0.5) * lane_width
        lanes.append(Lane(lid, _straight([length, y], [0, y]),
                          width=lane_width, speed_limit=speed_limit))
        lid += 1
    if parking_lane:
        y = -(lanes_per_dir + 0.5) * lane_width
        lanes.append(Lane(lid, _straight([0, y], [length, y]),
                          width=lane_width, lane_type="parking"))
        lid += 1
    _link_parallel(lanes, lanes_per_dir)
    return SimMap([Road(0, lanes)], name="MicroTown_Straight")


def curved_town(radius: float = 120.0, arc_deg: float = 120.0,
                lanes_per_dir: int = 1, lane_width: float = 3.5,
                speed_limit: float = 11.11) -> SimMap:
    """Constant-curvature left bend (for InvadingTurn-style scenarios)."""
    lanes: List[Lane] = []
    lid = 0
    n = max(int(radius * math.radians(arc_deg)) + 1, 16)
    ang = np.linspace(-math.pi / 2, -math.pi / 2 + math.radians(arc_deg), n)
    for i in range(lanes_per_dir):
        r = radius - (i + 0.5) * lane_width
        pts = np.stack([r * np.cos(ang), radius + r * np.sin(ang)], 1)
        lanes.append(Lane(lid, pts, width=lane_width,
                          speed_limit=speed_limit))
        lid += 1
    for i in range(lanes_per_dir):
        r = radius + (i + 0.5) * lane_width
        pts = np.stack([r * np.cos(ang), radius + r * np.sin(ang)], 1)[::-1]
        lanes.append(Lane(lid, pts, width=lane_width,
                          speed_limit=speed_limit))
        lid += 1
    _link_parallel(lanes, lanes_per_dir)
    return SimMap([Road(0, lanes)], name="MicroTown_Curve")


def crossing_town(arm: float = 150.0, lane_width: float = 3.5,
                  lights: bool = True,
                  stop_sign: bool = False,
                  t_junction: bool = False,
                  speed_limit: float = 11.11) -> SimMap:
    """Signalized 4-way crossing at the origin; ego route runs +x.

    The junction square spans [-j, j]^2 with j = 2 * lane_width; each
    through-lane runs arm->arm so route geometry is continuous.

    t_junction=True drops the NORTH arm (the side road joins from the
    south only), turning the crossing into a T junction (reference
    T_Junction scenario geometry): lane 2 (northbound) ends at the
    junction's south edge, lane 3 (southbound) starts there.
    """
    j = 2.0 * lane_width
    lanes: List[Lane] = []
    y_f, y_b = -0.5 * lane_width, 0.5 * lane_width
    # east-west road (ego): forward +x at y<0
    lanes.append(Lane(0, _straight([-arm, y_f], [arm, y_f]),
                      width=lane_width, speed_limit=speed_limit))
    lanes.append(Lane(1, _straight([arm, y_b], [-arm, y_b]),
                      width=lane_width, speed_limit=speed_limit))
    # north-south road: forward -y->+y at x>0 side
    n_top = -j if t_junction else arm
    lanes.append(Lane(2, _straight([y_b, -arm], [y_b, n_top]),
                      width=lane_width, speed_limit=speed_limit))
    lanes.append(Lane(3, _straight([y_f, n_top], [y_f, -arm]),
                      width=lane_width, speed_limit=speed_limit))
    for lane in lanes:
        lane.opposite = {0: 1, 1: 0, 2: 3, 3: 2}[lane.lane_id]
    junction = np.array([[-j, -j], [j, -j], [j, j], [-j, j]])
    tls, stops = [], []
    if lights:
        # one light per approach; stop line at the junction edge (a T
        # junction has no northern approach -> no light 3)
        tls = [
            TrafficLightSpot(0, 0, np.array([-j, y_f]), 0.0),
            TrafficLightSpot(1, 1, np.array([j, y_b]), math.pi),
            TrafficLightSpot(2, 2, np.array([y_b, -j]), math.pi / 2),
        ]
        if not t_junction:
            tls.append(TrafficLightSpot(3, 3, np.array([y_f, j]),
                                        -math.pi / 2))
    if stop_sign:
        stops = [StopSignSpot(0, 0, np.array([-j - 1.0, y_f]), 0.0)]
    return SimMap([Road(0, lanes[:2]), Road(1, lanes[2:])],
                  junctions=[junction], lights=tls, stops=stops,
                  name="MicroTown_TJunction" if t_junction
                  else "MicroTown_Crossing")


def highway_town(length: float = 500.0, lanes_per_dir: int = 2,
                 lane_width: float = 3.5, ramp: str = "exit",
                 ramp_at: float = 250.0, ramp_len: float = 70.0,
                 ramp_offset: float = 6.0,
                 speed_limit: float = 13.89) -> SimMap:
    """Straight multi-lane highway along +x with one ramp lane.

    ramp="exit": the ramp runs parallel beside the outermost forward lane
    (gore area) from `ramp_at`, then peels away laterally by `ramp_offset`
    over `ramp_len` and continues parallel (HighwayExit geometry).
    ramp="entry": mirror image -- the ramp approaches from the side,
    becomes parallel at `ramp_at`, and ENDS ~40 m later (forced merge --
    MergerIntoSlowTraffic geometry).
    """
    base = straight_town(length=length, lanes_per_dir=lanes_per_dir,
                         lane_width=lane_width, speed_limit=speed_limit)
    lanes = [base.lanes[i] for i in sorted(base.lanes)]
    outer = lanes[lanes_per_dir - 1]          # rightmost forward lane
    y0 = -(lanes_per_dir + 0.5) * lane_width  # parallel-ramp centerline y
    lid = max(base.lanes) + 1
    xs: np.ndarray
    if ramp == "exit":
        gore = 25.0
        xs = np.arange(ramp_at, min(ramp_at + gore + ramp_len + 60.0,
                                    length - 5.0), 1.0)
        ys = np.where(
            xs < ramp_at + gore, y0,
            y0 - ramp_offset * np.clip(
                (xs - ramp_at - gore) / ramp_len, 0.0, 1.0) ** 2)
    elif ramp == "entry":
        x_start = max(ramp_at - ramp_len, 5.0)
        xs = np.arange(x_start, min(ramp_at + 40.0, length - 5.0), 1.0)
        ys = np.where(
            xs >= ramp_at, y0,
            y0 - ramp_offset * np.clip(
                (ramp_at - xs) / ramp_len, 0.0, 1.0) ** 2)
    else:
        raise ValueError(f"ramp must be 'exit' or 'entry', got {ramp!r}")
    ramp_lane = Lane(lid, np.stack([xs, ys], 1), width=lane_width,
                     speed_limit=speed_limit)
    ramp_lane.left = outer.lane_id
    outer.right = ramp_lane.lane_id
    roads = [Road(0, lanes), Road(1, [ramp_lane])]
    return SimMap(roads, name=f"MicroTown_Highway_{ramp}")


def crossing_route(town: SimMap, start_s: float, end_s: float,
                   turn: str = "straight",
                   spacing: float = 1.0) -> np.ndarray:
    """Ego turn route through the crossing: approach on lane 0
    (eastbound), then a left turn onto the northbound lane (2) or a right
    turn onto the southbound lane (3), continuing for `end_s` metres of
    total arc length. The connector comes from route_between's
    tangent-matched Hermite -- ONE junction-connector geometry for both
    the executable ego route and the route-tooling traces
    (MicrosimRouteMap)."""
    if turn not in ("left", "right"):
        raise ValueError(f"turn must be 'left' or 'right', got {turn!r}; "
                         "straight crossing routes use the plain lane grid")
    lane_in = town.lanes[0]
    lane_out = town.lanes[2 if turn == "left" else 3]
    j = float(np.abs(town.junctions[0]).max())     # junction half-size
    start = lane_in.point_at_s(start_s)
    # exit-lane arc position just past the junction; extend to use up the
    # remaining route budget
    s_exit_edge, _ = lane_out.project(
        [lane_out.center[0, 0], 0.0] if turn == "left"
        else [lane_out.center[-1, 0], 0.0])
    s_exit_edge = max(s_exit_edge, j + 2.0)
    approach_len = max(0.0, -j - start[0])
    remaining = max(end_s - start_s - approach_len - 2.0 * j, 10.0)
    end = lane_out.point_at_s(s_exit_edge + remaining)
    return town.route_between(start, end, spacing=spacing)


def grid_town(blocks_x: int = 2, blocks_y: int = 2, block: float = 120.0,
              lane_width: float = 3.5, lights: bool = True,
              speed_limit: float = 11.11) -> SimMap:
    """City grid: (blocks_x+1) x (blocks_y+1) two-way streets with a
    signalized junction at every intersection -- the microsim's multi-
    junction town for multi-turn routes (spec "via" waypoints chain
    through route_between's junction connectors)."""
    w, hgt = blocks_x * block, blocks_y * block
    half = 0.5 * lane_width
    j = 2.0 * lane_width
    lanes: List[Lane] = []
    roads: List[Road] = []
    lid = 0
    for jy in range(blocks_y + 1):
        y = jy * block
        east = Lane(lid, _straight([0, y - half], [w, y - half]),
                    width=lane_width, speed_limit=speed_limit)
        west = Lane(lid + 1, _straight([w, y + half], [0, y + half]),
                    width=lane_width, speed_limit=speed_limit)
        east.opposite, west.opposite = west.lane_id, east.lane_id
        lanes += [east, west]
        roads.append(Road(jy, [east, west]))
        lid += 2
    for ix in range(blocks_x + 1):
        x = ix * block
        north = Lane(lid, _straight([x + half, 0], [x + half, hgt]),
                     width=lane_width, speed_limit=speed_limit)
        south = Lane(lid + 1, _straight([x - half, hgt], [x - half, 0]),
                     width=lane_width, speed_limit=speed_limit)
        north.opposite, south.opposite = south.lane_id, north.lane_id
        lanes += [north, south]
        roads.append(Road(100 + ix, [north, south]))
        lid += 2
    junctions, tls = [], []
    light_id = 0
    for ix in range(blocks_x + 1):
        for jy in range(blocks_y + 1):
            cx, cy = ix * block, jy * block
            junctions.append(np.array(
                [[cx - j, cy - j], [cx + j, cy - j],
                 [cx + j, cy + j], [cx - j, cy + j]]))
            if not lights:
                continue
            east = roads[jy].lanes[0]
            west = roads[jy].lanes[1]
            north = roads[blocks_y + 1 + ix].lanes[0]
            south = roads[blocks_y + 1 + ix].lanes[1]
            # approach stop lines at the junction edges; ids base+0/+1
            # are the E/W approaches and base+2/+3 the N/S ones, so
            # SimWorld's (light_id // 2) % 2 phase rule puts crossing
            # roads on opposite phases
            tls += [
                TrafficLightSpot(light_id, east.lane_id,
                                 np.array([cx - j, cy - half]), 0.0),
                TrafficLightSpot(light_id + 1, west.lane_id,
                                 np.array([cx + j, cy + half]), math.pi),
                TrafficLightSpot(light_id + 2, north.lane_id,
                                 np.array([cx + half, cy - j]),
                                 math.pi / 2),
                TrafficLightSpot(light_id + 3, south.lane_id,
                                 np.array([cx - half, cy + j]),
                                 -math.pi / 2),
            ]
            light_id += 4
    return SimMap(roads, junctions=junctions, lights=tls,
                  name="MicroTown_Grid")


def _link_parallel(lanes: List[Lane], lanes_per_dir: int) -> None:
    """Set left/right/opposite links for the straight/curved builders."""
    for i in range(lanes_per_dir):
        lane = lanes[i]
        lane.left = lanes[i - 1].lane_id if i > 0 else None
        lane.right = (lanes[i + 1].lane_id
                      if i + 1 < lanes_per_dir else None)
        if i == 0:
            lane.opposite = lanes[lanes_per_dir].lane_id
        back = lanes[lanes_per_dir + i]
        back.left = (lanes[lanes_per_dir + i - 1].lane_id
                     if i > 0 else None)
        back.right = (lanes[lanes_per_dir + i + 1].lane_id
                      if i + 1 < lanes_per_dir else None)
        if i == 0:
            back.opposite = lanes[0].lane_id
    # parking lane rides to the right of the outermost forward lane
    for lane in lanes:
        if lane.lane_type == "parking":
            outer = lanes[lanes_per_dir - 1]
            outer.right = lane.lane_id
            lane.left = outer.lane_id

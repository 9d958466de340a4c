"""Privileged dense-route construction for the expert.

Copy of `simlingo_tpu/expert/route_planner.py`.

Behavioral counterpart of reference `team_code/privileged_route_planner.py`
(PrivilegedRoutePlanner): densify the sparse global plan to ~0.1 m spacing,
track ego progress with a windowed closest-point search, and modify the
route geometrically for lane changes and static-obstacle bypasses (the
reference does this from CARLA map waypoints; here the same shapes are
produced from pure geometry so the expert is simulator-independent and the
CARLA plugin only needs to feed sparse waypoints).

All routes are [N, 2] float arrays in global coordinates; `ego_inputs`
produces the ego-frame views the AutoPilot/measurement schema consumes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def densify_route(points: np.ndarray, spacing: float = 0.1) -> np.ndarray:
    """Arc-length resample a sparse polyline to fixed spacing.

    Reference privileged_route_planner densifies map waypoints to 10 cm so
    index arithmetic equals distance arithmetic (idx ~= metres * 10).
    """
    pts = np.asarray(points, float)[:, :2]
    if len(pts) < 2:
        return pts.copy()
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    keep = np.concatenate([[True], seg > 1e-9])
    pts = pts[keep]
    if len(pts) < 2:
        return pts.copy()
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    grid = np.arange(0.0, s[-1] + spacing * 0.5, spacing)
    return np.stack([np.interp(grid, s, pts[:, 0]),
                     np.interp(grid, s, pts[:, 1])], axis=1)


def route_normals(route: np.ndarray) -> np.ndarray:
    """Unit left normals of a dense route (rotate tangent +90 deg)."""
    tang = np.gradient(route, axis=0)
    norm = np.linalg.norm(tang, axis=1, keepdims=True)
    tang = tang / np.maximum(norm, 1e-9)
    return np.stack([-tang[:, 1], tang[:, 0]], axis=1)


def _ramp(n: int) -> np.ndarray:
    """Smooth 0->1 ramp (cosine easing), C1 at both ends."""
    if n <= 1:
        return np.ones(max(n, 0))
    t = np.linspace(0.0, 1.0, n)
    return 0.5 * (1.0 - np.cos(np.pi * t))


def lateral_offset_profile(n_points: int, start: int, transition: int,
                           hold: Optional[int], ret: int) -> np.ndarray:
    """Offset fraction in [0, 1] per route point: ramp in over `transition`
    points, hold for `hold` points (None = keep the new lane to the end,
    i.e. a true lane change), ramp back over `ret` points."""
    prof = np.zeros(n_points)
    i0 = int(np.clip(start, 0, n_points))
    i1 = int(np.clip(i0 + transition, 0, n_points))
    prof[i0:i1] = _ramp(i1 - i0)
    if hold is None:
        prof[i1:] = 1.0
        return prof
    i2 = int(np.clip(i1 + hold, 0, n_points))
    prof[i1:i2] = 1.0
    i3 = int(np.clip(i2 + ret, 0, n_points))
    prof[i2:i3] = 1.0 - _ramp(i3 - i2)
    return prof


def plan_lane_change(route: np.ndarray, start_idx: int, lateral_shift: float,
                     transition_length: float = 25.0,
                     hold_length: Optional[float] = None,
                     return_length: float = 25.0,
                     spacing: float = 0.1) -> np.ndarray:
    """Shift the route laterally by `lateral_shift` metres (positive = left)
    with smooth transitions. hold_length=None keeps the new lane forever
    (reference lane-change scenarios); a finite hold produces a bypass that
    merges back (reference parked-obstacle avoidance)."""
    route = np.asarray(route, float)
    prof = lateral_offset_profile(
        len(route), start_idx,
        max(int(round(transition_length / spacing)), 1),
        None if hold_length is None
        else max(int(round(hold_length / spacing)), 0),
        max(int(round(return_length / spacing)), 1))
    return route + (lateral_shift * prof)[:, None] * route_normals(route)


def plan_obstacle_bypass(route: np.ndarray, obstacle_xy: Sequence[float],
                         clearance: float = 2.5,
                         obstacle_extent: float = 3.0,
                         transition_length: float = 15.0,
                         spacing: float = 0.1
                         ) -> Tuple[np.ndarray, bool]:
    """Bypass a static obstacle sitting on/near the route, merging back
    after it. Shift direction is away from the obstacle's side of the route.
    Returns (new_route, changed) -- unchanged if the obstacle is farther
    than `clearance` from the route."""
    route = np.asarray(route, float)
    obs = np.asarray(obstacle_xy, float)[:2]
    d = np.linalg.norm(route - obs, axis=1)
    i_hit = int(np.argmin(d))
    if d[i_hit] > clearance:
        return route, False
    normals = route_normals(route)
    side = float(np.dot(obs - route[i_hit], normals[i_hit]))
    shift = -np.sign(side or 1.0) * (clearance - abs(side)
                                     + 0.5)  # 0.5 m margin
    half = obstacle_extent / spacing
    start = max(int(i_hit - half - transition_length / spacing), 0)
    return plan_lane_change(route, start, shift, transition_length,
                            hold_length=2 * obstacle_extent,
                            return_length=transition_length,
                            spacing=spacing), True


class PrivilegedRoutePlanner:
    """Dense global route with ego-progress tracking and modification.

    Reference privileged_route_planner.py: run_step advances a persistent
    closest-point index inside a forward search window (never backwards, so
    loops in the route don't snap the ego back), and exposes remaining
    route + original (pre-modification) route for the measurement schema.
    """

    # CARLA RoadOption ids (data/measurements.COMMAND_MAP)
    LANEFOLLOW, CHANGELANELEFT, CHANGELANERIGHT = 4, 5, 6

    def __init__(self, spacing: float = 0.1, search_window_m: float = 30.0):
        self.spacing = spacing
        self.search_window = max(int(search_window_m / spacing), 2)
        self.route = np.zeros((0, 2))
        self.route_original = np.zeros((0, 2))
        self.commands: List[int] = []
        self.idx = 0
        self.changed_route = False

    def set_route(self, sparse_points: np.ndarray,
                  command: int = 4,
                  start_xy: Optional[Sequence[float]] = None,
                  parking_exit: bool = False,
                  extend_m: float = 0.0) -> None:
        """parking_exit: the global plan's first waypoint sits on the road
        center while the vehicle starts in a parking lane (reference
        setup_route starts_with_parking_exit workaround,
        privileged_route_planner.py:428-433): prepend the vehicle position
        and command the merge as a lane change. extend_m: extrapolate the
        route `extend_m` metres past the goal so progress indexing never
        clamps at the end (reference extra_route_length :445-452)."""
        sparse = np.asarray(sparse_points, float)[:, :2]
        lead_cmds = 0
        if parking_exit and start_xy is not None:
            start = np.asarray(start_xy, float)[None, :2]
            sparse = np.concatenate([start, sparse], 0)
            lead_cmds = 1
        if extend_m > 0.0 and len(sparse) >= 2:
            tail = sparse[-1] - sparse[-2]
            tail = tail / max(np.linalg.norm(tail), 1e-9)
            sparse = np.concatenate(
                [sparse, (sparse[-1] + tail * extend_m)[None]], 0)
        self.route = densify_route(sparse, self.spacing)
        self.route_original = self.route.copy()
        self.commands = [command] * len(self.route)
        if lead_cmds:
            # merge out of the parking lane: CHANGELANELEFT until back on
            # the planned route (first ~15 m)
            n = min(int(15.0 / self.spacing), len(self.commands))
            self.commands[:n] = [self.CHANGELANELEFT] * n
        self.idx = 0
        self.changed_route = False

    # -- modifications ----------------------------------------------------
    def _write_commands(self, start: int, end: int, command: int) -> None:
        start = int(np.clip(start, 0, len(self.commands)))
        end = int(np.clip(end, start, len(self.commands)))
        self.commands[start:end] = [command] * (end - start)

    def request_lane_change(self, direction: str, lane_width: float = 3.5,
                            transition_length: float = 25.0,
                            at_distance: float = 0.0,
                            lane_widths: Optional[np.ndarray] = None,
                            min_lane_width: float = 2.5) -> None:
        """direction in {'left','right'}; applied `at_distance` m ahead.

        lane_widths: optional per-route-point width of the TARGET lane; if
        given, the transition is deferred until the lane is at least
        `min_lane_width` wide for its whole length (reference
        prevent_too_early_lane_changes, privileged_route_planner.py:558-589
        -- forming lanes must not be entered while still too narrow)."""
        shift = lane_width if direction == "left" else -lane_width
        start = self.idx + int(at_distance / self.spacing)
        trans = max(int(round(transition_length / self.spacing)), 1)
        if lane_widths is not None:
            widths = np.asarray(lane_widths, float)
            while start + trans < len(widths) and \
                    (widths[start:start + trans] < min_lane_width).any():
                start += 1
        self.route = plan_lane_change(self.route, start, shift,
                                      transition_length, None,
                                      spacing=self.spacing)
        self._write_commands(start, start + trans,
                             self.CHANGELANELEFT if direction == "left"
                             else self.CHANGELANERIGHT)
        self.changed_route = True

    def add_obstacle(self, obstacle_xy: Sequence[float],
                     clearance: float = 2.5,
                     obstacle_extent: float = 3.0,
                     transition_length: float = 15.0) -> bool:
        before = self.route
        self.route, changed = plan_obstacle_bypass(
            self.route, obstacle_xy, clearance, obstacle_extent,
            transition_length, spacing=self.spacing)
        if changed:
            # mark the transition ramps as lane-change commands (reference
            # shift_route_smoothly writes CHANGELANELEFT/RIGHT, :256-270)
            dev = np.einsum(
                "ij,ij->i", self.route - before, route_normals(before))
            moving = np.abs(dev) > 0.05
            if moving.any():
                i0 = int(np.argmax(moving))
                i1 = len(moving) - int(np.argmax(moving[::-1]))
                trans = max(int(round(transition_length / self.spacing)), 1)
                left_in = dev[min(i0 + trans, len(dev) - 1)] > 0
                self._write_commands(
                    i0, min(i0 + trans, i1),
                    self.CHANGELANELEFT if left_in
                    else self.CHANGELANERIGHT)
                self._write_commands(
                    max(i1 - trans, i0), i1,
                    self.CHANGELANERIGHT if left_in
                    else self.CHANGELANELEFT)
        self.changed_route = self.changed_route or changed
        return changed

    def near_lane_change(self, behind_m: float = 20.0,
                         ahead_m: float = 40.0) -> bool:
        """Is a lane change commanded near the current position? Drives
        the expert's longer forecast horizon and stricter rear-vehicle
        handling (reference compute_trailing_vehicles :854-859 scans the
        recent command window)."""
        lo = max(self.idx - int(behind_m / self.spacing), 0)
        hi = min(self.idx + int(ahead_m / self.spacing),
                 len(self.commands))
        return any(c in (self.CHANGELANELEFT, self.CHANGELANERIGHT)
                   for c in self.commands[lo:hi])

    def index_of(self, point_xy: Sequence[float]) -> int:
        """Route index closest to a global point (full-route search)."""
        if len(self.route) == 0:
            return 0
        p = np.asarray(point_xy, float)[:2]
        return int(np.argmin(np.linalg.norm(self.route - p, axis=1)))

    def shift_route_between(self, from_idx: int, to_idx: int,
                            lateral_shift: float,
                            transition_length: float = 8.0) -> None:
        """Shift the route span [from_idx, to_idx] laterally (positive =
        left) with smooth ramps on both sides -- the scenario-management
        primitive (reference privileged_route_planner
        shift_route_around_actors / shift_route_smoothly / shift_route_for_
        invading_turn are all spans with eased transitions)."""
        from_idx = int(np.clip(from_idx, 0, max(len(self.route) - 1, 0)))
        to_idx = int(np.clip(to_idx, from_idx, max(len(self.route) - 1, 0)))
        trans = max(int(round(transition_length / self.spacing)), 1)
        start = max(from_idx - trans, 0)
        prof = lateral_offset_profile(
            len(self.route), start, from_idx - start,
            to_idx - from_idx, trans)
        self.route = self.route \
            + (lateral_shift * prof)[:, None] * route_normals(self.route)
        into = (self.CHANGELANELEFT if lateral_shift > 0
                else self.CHANGELANERIGHT)
        back = (self.CHANGELANERIGHT if lateral_shift > 0
                else self.CHANGELANELEFT)
        self._write_commands(start, from_idx, into)
        self._write_commands(to_idx, to_idx + trans, back)
        self.changed_route = True

    def extend_shift(self, old_to_idx: int, new_to_idx: int,
                     lateral_shift: float,
                     transition_length: float = 8.0) -> None:
        """Push an existing shift's ramp-down from old_to_idx out to
        new_to_idx (reference extend_lane_shift_transition_for_yield_to_
        emergency_vehicle / _for_hazard_at_side_lane: the actor is still
        there when the planned span ends, so the merge-back is deferred).

        Exact by ramp algebra: the original span added off*rampdown over
        [old_to, old_to+T]; this adds off*rampup over the same window
        (cosine rampup == 1 - rampdown, so the sum holds the offset flat),
        then the full offset until the new ramp-down before new_to_idx.
        Offsets ride the ORIGINAL route's normals -- the shifted route is
        ramping through this window and its own normals tilt by
        atan(pi*off/2T). Must use the SAME transition_length as the
        original shift.
        """
        n = len(self.route)
        old_to_idx = int(np.clip(old_to_idx, 0, max(n - 1, 0)))
        new_to_idx = int(np.clip(new_to_idx, old_to_idx, max(n - 1, 0)))
        trans = max(int(round(transition_length / self.spacing)), 1)
        prof = lateral_offset_profile(
            n, old_to_idx, trans, new_to_idx - (old_to_idx + trans), trans)
        self.route = self.route + (lateral_shift * prof)[:, None] \
            * route_normals(self.route_original)
        into = (self.CHANGELANELEFT if lateral_shift > 0
                else self.CHANGELANERIGHT)
        back = (self.CHANGELANERIGHT if lateral_shift > 0
                else self.CHANGELANELEFT)
        # the stale merge-back on [old_to, old_to+T] becomes lane-keeping;
        # the real merge-back moves to new_to_idx
        self._write_commands(old_to_idx, old_to_idx + trans, into)
        self._write_commands(new_to_idx, new_to_idx + trans, back)
        self.changed_route = True

    # -- stepping ----------------------------------------------------------
    def run_step(self, pos_global: Sequence[float]) -> int:
        """Advance the progress index (forward-only windowed search)."""
        if len(self.route) == 0:
            return 0
        pos = np.asarray(pos_global, float)[:2]
        lo = self.idx
        hi = min(self.idx + self.search_window, len(self.route))
        d = np.linalg.norm(self.route[lo:hi] - pos, axis=1)
        self.idx = lo + int(np.argmin(d))
        return self.idx

    @property
    def is_last(self) -> bool:
        return self.idx >= len(self.route) - 2

    def ego_inputs(self, pos_global: Sequence[float], yaw: float,
                   n_points: int = 400,
                   tp_distances: Tuple[float, float] = (30.0, 60.0)
                   ) -> Dict:
        """Everything ExpertObservation needs: ego-frame dense route (and
        original), target points at fixed arc distances, changed flag."""
        self.run_step(pos_global)
        pos = np.asarray(pos_global, float)[:2]
        c, s = np.cos(yaw), np.sin(yaw)
        rot_t = np.array([[c, s], [-s, c]])

        def to_ego(pts: np.ndarray) -> np.ndarray:
            return (pts - pos) @ rot_t.T

        def window(full: np.ndarray) -> np.ndarray:
            w = full[self.idx:self.idx + n_points]
            if len(w) < n_points and len(full):   # pad by repeating the end
                w = np.concatenate(
                    [w, np.repeat(full[-1:], n_points - len(w), 0)])
            return to_ego(w)

        route_ego = window(self.route)
        tps = []
        for dist in tp_distances:
            j = min(self.idx + int(dist / self.spacing),
                    max(len(self.route) - 1, 0))
            tps.append(to_ego(self.route[j:j + 1])[0])
        return {
            "route": route_ego,
            "route_original": window(self.route_original),
            "target_point": tps[0],
            "target_point_next": tps[1],
            "command": self.commands[min(self.idx,
                                         len(self.commands) - 1)]
            if self.commands else 4,
            "changed_route": self.changed_route,
            "is_last": self.is_last,
        }

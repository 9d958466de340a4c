"""Dreamer alternative-trajectory generation by forward simulation.

Copy of `simlingo_tpu/labels/dreamer_gen.py`.

Behavioral counterpart of reference
`dataset_generation/dreamer_data/dreamer_generator.py`
(CarlaAlternativeCreator.process_data + forecast_vehicles): per frame, every
alternative is ROLLED OUT with the kinematic bicycle model at 20 Hz under a
lateral PID steering toward the (possibly modified) route and a longitudinal
policy per mode -- so lane changes, crash trajectories and speed edits are
all dynamically feasible. Modes (reference :358-737):

  * target_speed  -- random target, regression throttle controller
  * stop          -- target speed 0
  * faster_factor -- expert speed profile x uniform(1.1, 1.5)
  * slower_factor -- expert speed profile x uniform(0.3, 0.9)
  * faster        -- fixed throttle drawn from three bands
  * slower        -- Bernoulli full-brake draws
  * crash         -- route spliced through a visible object near the route,
                     target speed chosen to arrive at its (GT-future) position
  * lane_change   -- route shifted by the summed widths of the crossed lanes
                     over a randomized (start, transition) window; one option
                     per reachable lane incl. opposite/parking/sidewalk
  * route         -- negative: the pre-deviation route on changed_route frames

Safety: rolled-out ego boxes are tested per-timestep against ground-truth
future actor boxes (from the recorded future frames, transformed into the
current ego frame -- reference get_bbs :1132-1177) with the exact 2D OBB SAT
from `expert/forecast.py`; the verdict + instruction text + refusals come
from `labels/dreamer_instructions.get_info`.

Output: dreamer/NNNN.json.gz, {mode: [option dicts]} in the layout
`data/dreamer_dataset.py` consumes.

Deviation from the reference: ego-frame 4 Hz samples are taken at
t = 0.25..2.5 s ([4::5] of the 20 Hz rollout) so waypoints sit on the label
grid; the reference's [::5] yields t = 0.05, 0.30, ... Where recorded future
frames are missing the frame is skipped (reference behavior).
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simlingo_tpu_torch.agent.controllers import LateralPIDController
from simlingo_tpu_torch.agent.ukf import bicycle_model_forward
from simlingo_tpu_torch.data import measurements as M
from simlingo_tpu_torch.expert import forecast as F
from simlingo_tpu_torch.expert.autopilot import LongitudinalLinearRegressionController
from simlingo_tpu_torch.labels import dreamer_instructions as DI
from simlingo_tpu_torch.utils.geometry import conversion_2d, inverse_conversion_2d

CARLA_FPS = 20                 # simulated physics rate
DATA_FPS = 4                   # label frame rate
WP_DT = 1.0 / DATA_FPS
SUBSAMPLE = CARLA_FPS // DATA_FPS
FORECAST_SECONDS = 2.5
N_SIM = int(CARLA_FPS * FORECAST_SECONDS)      # 50 physics steps
NUM_WPS = N_SIM // SUBSAMPLE                   # 10 waypoints at 4 Hz
FUTURE_LEN = 10                # frames of recorded future needed (incl. cur)

EGO_EXTENT = (2.45, 0.9)       # half-sizes, matches the expert's ego


# ---------------------------------------------------------------------------
# Ego rollout (reference forecast_vehicles :1180-1356)
# ---------------------------------------------------------------------------

def _interp_rows(arr: np.ndarray, n_out: int) -> np.ndarray:
    """Linear resample of a [T, ...] series to n_out rows (4 Hz -> 20 Hz)."""
    arr = np.asarray(arr, float)
    t_in = np.arange(len(arr), dtype=float)
    t_out = np.arange(n_out, dtype=float) * (DATA_FPS / CARLA_FPS)
    t_out = np.minimum(t_out, t_in[-1])
    if arr.ndim == 1:
        return np.interp(t_out, t_in, arr)
    return np.stack([np.interp(t_out, t_in, arr[:, k])
                     for k in range(arr.shape[1])], axis=1)


def rollout_ego(current: Dict, route: Optional[np.ndarray],
                future_measurements: Sequence[Dict] = (),
                *, target_speed: Optional[float] = None,
                speeds_to_follow: Optional[np.ndarray] = None,
                desired_throttle: Optional[float] = None,
                brake_probability: Optional[float] = None,
                rng: Optional[np.random.RandomState] = None,
                return_states: bool = False) -> Dict[str, np.ndarray]:
    """Kinematic-bicycle rollout of the ego in its own frame.

    Exactly one of target_speed / speeds_to_follow / desired_throttle /
    brake_probability may be set; with none set the recorded expert actions
    (current + future frames, 4 Hz -> 20 Hz interpolated) are replayed --
    the reference's default action source.

    Returns 4 Hz samples: waypoints [NUM_WPS, 2], yaws [NUM_WPS],
    speeds [NUM_WPS], final_speed; with return_states also the full 20 Hz
    states [N_SIM, 4].
    """
    assert sum(x is not None for x in
               (target_speed, speeds_to_follow, desired_throttle,
                brake_probability)) <= 1
    rng = rng or np.random.RandomState(0)
    dt = 1.0 / CARLA_FPS

    actions = np.array([[float(current.get("steer", 0.0)),
                         float(current.get("throttle", 0.0)),
                         float(bool(current.get("brake", False)))]]
                       + [[float(m.get("steer", 0.0)),
                           float(m.get("throttle", 0.0)),
                           float(bool(m.get("brake", False)))]
                          for m in future_measurements])
    actions20 = _interp_rows(actions, N_SIM)

    lateral = LateralPIDController(inference_mode=True)
    longitudinal = LongitudinalLinearRegressionController()

    x = np.array([0.0, 0.0, 0.0, float(current.get("speed", 0.0))])
    steer, throttle, brake = actions[0]
    route_active = route is not None and len(route) >= 2
    if route_active:
        route = np.asarray(route, float)[:, :2]

    states = np.zeros((N_SIM, 4))
    for i in range(N_SIM):
        x = bicycle_model_forward(x, dt, float(steer), float(throttle),
                                  bool(brake > 0.5))
        states[i] = x
        steer, throttle, brake = actions20[i]

        if route_active:
            # steer toward the route from the rolled-out pose; drop the
            # closest point (+1) to avoid oscillation (reference :1249)
            c, s = np.cos(x[2]), np.sin(x[2])
            rel = route - x[:2]
            local = np.stack([c * rel[:, 0] + s * rel[:, 1],
                              -s * rel[:, 0] + c * rel[:, 1]], axis=1)
            closest = int(np.argmin(np.linalg.norm(local, axis=1))) + 1
            if closest >= len(route):
                route_active = False        # past the end: replay actions
            else:
                steer = lateral.step(local[closest:], x[3])

        if speeds_to_follow is not None:
            desired = float(speeds_to_follow[min(i, len(speeds_to_follow)-1)])
            throttle, brake = longitudinal.step(x[3], desired)
        elif desired_throttle is not None:
            throttle, brake = float(desired_throttle), False
        elif brake_probability is not None:
            throttle = 0.0
            brake = bool(rng.rand() < brake_probability)
        elif target_speed is not None:
            throttle, brake = longitudinal.step(x[3], float(target_speed))

    sub = states[SUBSAMPLE - 1::SUBSAMPLE]
    out = {
        "waypoints": sub[:, :2].copy(),
        "yaws": sub[:, 2].copy(),
        "speeds": sub[:, 3].copy(),
        "final_speed": round(float(states[-1, 3]), 1),
    }
    if return_states:
        out["states"] = states
    return out


# ---------------------------------------------------------------------------
# Ground-truth future actor tracks (reference get_bbs :1132-1177)
# ---------------------------------------------------------------------------

def _is_walker_box(b: Dict) -> bool:
    kind = str(b.get("class", "")) + str(b.get("type_id", ""))
    return "walker" in kind or "pedestrian" in kind


def _is_vehicle_box(b: Dict) -> bool:
    c = str(b.get("class", ""))
    return c in ("car", "vehicle") or str(b.get("type_id", "")
                                          ).startswith("vehicle")


def gt_actor_tracks(current: Dict, boxes: Sequence[Dict],
                    future_measurements: Sequence[Dict],
                    future_boxes: Sequence[Sequence[Dict]]
                    ) -> Dict[object, Dict[str, np.ndarray]]:
    """Recorded actor positions through the future frames, re-expressed in
    the CURRENT ego frame: {id: {centers [T,2], yaws [T], extents [T,2],
    valid [T]}} with T = 1 + len(future_boxes) at 4 Hz.

    Vehicles missing from a future frame reuse their last observation;
    walkers are dropped for those steps (despawn = gone, reference :272-305).
    """
    ego0_pos = np.asarray(current.get("pos_global", [0.0, 0.0]), float)[:2]
    ego0_yaw = float(current.get("theta", 0.0))
    ego_pose = [(ego0_pos, ego0_yaw)] + [
        (np.asarray(m.get("pos_global", [0.0, 0.0]), float)[:2],
         float(m.get("theta", 0.0))) for m in future_measurements]

    tracked = [b for b in boxes
               if (_is_vehicle_box(b) or _is_walker_box(b))
               and "position" in b and b.get("id") is not None]
    T = 1 + len(future_boxes)
    out: Dict[object, Dict[str, np.ndarray]] = {}
    for b in tracked:
        walker = _is_walker_box(b)
        pad = 0.5 if walker else 0.0
        centers = np.zeros((T, 2))
        yaws = np.zeros(T)
        extents = np.zeros((T, 2))
        valid = np.zeros(T, bool)
        last = b
        last_t = 0
        for t in range(T):
            frame_boxes = [b] if t == 0 else [
                fb for fb in future_boxes[t - 1]
                if fb.get("id") == b["id"]]
            if frame_boxes:
                last, last_t = frame_boxes[0], t
            elif walker:
                continue                    # despawned: no box this step
            pos_t, yaw_t = ego_pose[min(last_t, len(ego_pose) - 1)]
            p_local = np.asarray(last["position"], float)[:2]
            p_global = conversion_2d(p_local, pos_t, -yaw_t)
            centers[t] = inverse_conversion_2d(p_global, ego0_pos, ego0_yaw)
            yaws[t] = float(last.get("yaw", 0.0)) + yaw_t - ego0_yaw
            ext = np.asarray(last.get("extent", [0.5, 0.5]), float)[:2]
            extents[t] = ext + pad
            valid[t] = True
        if valid.any():
            out[b["id"]] = {"centers": centers, "yaws": yaws,
                            "extents": extents, "valid": valid,
                            "box": b}
    return out


def dynamic_crash_check(ego_wps: np.ndarray, ego_yaws: np.ndarray,
                        tracks: Dict[object, Dict[str, np.ndarray]]
                        ) -> Tuple[bool, List[int]]:
    """Rolled-out ego OBBs vs GT actor OBBs per 4 Hz step
    (reference :743-771). Ego step k (t = (k+1)/4 s) meets actor frame
    k+1."""
    n = len(ego_wps)
    ego_ext = np.broadcast_to(np.asarray(EGO_EXTENT), (n, 2))
    hit_steps: List[int] = []
    for tr in tracks.values():
        idx = np.arange(1, n + 1)
        idx = np.minimum(idx, len(tr["valid"]) - 1)
        ok = tr["valid"][idx]
        if not ok.any():
            continue
        hits = F.obb_intersect_batch(
            ego_wps[ok], ego_yaws[ok], ego_ext[ok],
            tr["centers"][idx][ok], tr["yaws"][idx][ok],
            tr["extents"][idx][ok])
        if hits.any():
            hit_steps.extend(np.nonzero(ok)[0][hits].tolist())
    hit_steps = sorted(set(hit_steps))
    return bool(hit_steps), hit_steps


# ---------------------------------------------------------------------------
# Crash-candidate selection + route splice (reference :446-629)
# ---------------------------------------------------------------------------

def _reachability_envelope(speed: float, steps_4hz: int) -> Tuple[float, float]:
    """Min/max forward distance the bicycle model can cover in the given
    number of 4 Hz steps under full brake / full throttle
    (reference get_min_max_pos_given_speed_and_deltaT :1503-1530)."""
    dt = 1.0 / CARLA_FPS
    x_min = np.array([0.0, 0.0, 0.0, speed])
    x_max = x_min.copy()
    for _ in range(steps_4hz * SUBSAMPLE):
        x_min = bicycle_model_forward(x_min, dt, 0.0, 0.0, True)
        x_max = bicycle_model_forward(x_max, dt, 0.0, 1.0, False)
    return float(x_min[0]), float(x_max[0])


def _object_visible(box: Dict) -> bool:
    from simlingo_tpu_torch.labels.vqa_scene import visible_in_image
    try:
        return visible_in_image(box)
    except Exception:
        return True


def select_crash_candidates(current: Dict, boxes: Sequence[Dict],
                            route_local: np.ndarray,
                            tracks: Dict[object, Dict[str, np.ndarray]],
                            rng: np.random.RandomState) -> List[Dict]:
    """Pick objects a crash trajectory can plausibly reach: visible in the
    camera, near the route, inside the bicycle model's reachability window
    at some future timestep."""
    speed = float(current.get("speed", 0.0))
    considered: List[np.ndarray] = []
    candidates: List[Dict] = []

    def _too_close_to_considered(pos) -> bool:
        return any(np.linalg.norm(c - pos[:2]) <= 1.0 for c in considered)

    for b in boxes:
        pos = np.asarray(b.get("position", [0.0, 0.0, 0.0]), float)
        if "position" not in b or pos[0] < 3:
            continue
        if not _object_visible(b):
            continue
        dist_route = float(np.min(np.linalg.norm(
            route_local - pos[None, :2], axis=1)))
        if dist_route >= 7:
            continue
        distance = float(b.get("distance", np.linalg.norm(pos[:2])))
        cls = str(b.get("class", ""))
        dynamic = _is_vehicle_box(b) or _is_walker_box(b)
        static = cls in ("static", "landmark") or "_vqa" in cls
        if dynamic and distance < 40:
            if _too_close_to_considered(pos):
                continue
            considered.append(pos[:2].copy())
            candidates.append({"box": b, "static": False})
        elif static and distance < 20:
            if "dirtdebris" in str(b.get("type_id", "")):
                continue
            if _too_close_to_considered(pos):
                continue
            considered.append(pos[:2].copy())
            candidates.append({"box": b, "static": True})

    picked: List[Dict] = []
    for cand in candidates:
        b = cand["box"]
        # candidate (position, 4 Hz timestep) pairs: static objects stay
        # put; dynamic ones move along their GT track. Skip the first two
        # steps (no reaction time, reference :491, :505).
        options: List[Tuple[np.ndarray, int]] = []
        if cand["static"]:
            p = np.asarray(b["position"], float)[:2]
            options = [(p, t) for t in range(2, FUTURE_LEN)]
        else:
            tr = tracks.get(b.get("id"))
            if tr is None:
                continue
            for t in range(2, min(FUTURE_LEN, len(tr["valid"]))):
                if tr["valid"][t] and tr["centers"][t][0] > 3:
                    options.append((tr["centers"][t], t))
        order = list(range(len(options)))
        rng.shuffle(order)
        for k in order:
            pos, t = options[k]
            distance = float(np.linalg.norm(pos))
            ext = np.asarray(b.get("extent", [0.5, 0.5]), float)
            # shave both bodies' extents off the gap (reference :534-541)
            axis = 0 if abs(pos[1]) < 1 else 1
            distance = max(0.0, distance - float(ext[axis]) - EGO_EXTENT[axis])
            lo, hi = _reachability_envelope(speed, t)
            if not (lo <= distance <= hi):
                continue
            target_speed = distance / (t * WP_DT) + 0.5
            type_str = str(b.get("type_id") or b.get("name")
                           or b.get("class", "object"))
            picked.append({"box": b, "position": pos, "timestep": t,
                           "target_speed": target_speed, "type": type_str})
            break
    return picked


def splice_crash_route(route_local: np.ndarray, crash_pos: np.ndarray
                       ) -> np.ndarray:
    """Route detoured through the crash position (reference :566-605)."""
    route_local = np.asarray(route_local, float)
    crash_pos = np.asarray(crash_pos, float)[:2]
    nearest = int(np.argmin(np.linalg.norm(route_local - crash_pos[None],
                                           axis=1)))
    before_end = nearest - 7
    after_start = nearest + 7
    if before_end < 1:
        before = route_local[:1].copy()
        if abs(before[0, 1]) > 2:
            before[0, 1] = 0.0
    else:
        before = route_local[:before_end]
    after = route_local[after_start:] if after_start < len(route_local) \
        else route_local[-1:]

    def _lerp(a, b):
        n = max(int(np.linalg.norm(b - a)), 1)
        return np.array([a + i * (b - a) / n for i in range(n)])

    parts = [before, _lerp(before[-1], crash_pos), crash_pos[None]]
    if len(after):
        parts.append(_lerp(crash_pos, after[0]))
        parts.append(after)
    spliced = np.concatenate(parts, axis=0)
    n_pts = max(int(np.ceil(np.linalg.norm(
        np.diff(spliced, axis=0), axis=1).sum())) + 1, 2)
    return M.equal_spacing_route(spliced, num_points=n_pts)


# ---------------------------------------------------------------------------
# Lane-change option enumeration (reference :632-737)
# ---------------------------------------------------------------------------

DEFAULT_LANE_WIDTH = 3.5


def _lane_width_sum(ego_info: Dict, direction: int) -> float:
    """Signed lateral offset to the target lane center: the summed widths of
    the crossed lanes (left negative y in the ego frame)."""
    n = abs(direction)
    key = "left_lanes" if direction < 0 else "right_lanes"
    lanes = [l for l in ego_info.get(key, [])
             if str(l.get("type:", l.get("type", ""))) != "Shoulder"]
    widths = [float(l.get("width", DEFAULT_LANE_WIDTH)) for l in lanes[:n]]
    widths += [DEFAULT_LANE_WIDTH] * (n - len(widths))
    total = sum(widths)
    return -total if direction < 0 else total


def calculate_shifted_trajectory(route: np.ndarray, start: int,
                                 transition: int, offset: float
                                 ) -> np.ndarray:
    """Keep the first `start` meters, then blend onto a route laterally
    shifted by `offset` over `transition` meters (reference
    calculate_shifted_trajectory :1359-1400 keeps the pre-window points and
    jumps to the shifted line after the window; the linear blend here makes
    the commanded path continuous -- the PID rollout smooths either way)."""
    route = np.asarray(route, float)
    d = np.gradient(route, axis=0)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-6)
    # normal (-dy, dx): +y for a straight route, so a negative offset
    # (= crossing lanes to the left) shifts toward -y, CARLA's left
    normal = np.stack([-d[:, 1], d[:, 0]], axis=1)
    shifted = route + offset * normal
    arc = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(route, axis=0), axis=1))])
    blend = np.clip((arc - start) / max(transition, 1), 0.0, 1.0)[:, None]
    return route * (1 - blend) + shifted * blend


def enumerate_lane_changes(current: Dict, ego_info: Dict,
                           rng: np.random.RandomState) -> List[Dict]:
    """All reachable target lanes with legality flags."""
    command = int(current.get("command", 4))
    if (current.get("changed_route")
            or str(ego_info.get("lane_type_str", "Driving")) == "Parking"
            or command in (5, 6)
            or ego_info.get("is_in_junction")
            or (ego_info.get("distance_to_junction") is not None
                and float(ego_info["distance_to_junction"]) < 10)):
        return []

    n_same = int(ego_info.get("num_lanes_same_direction", 1))
    n_opp = int(ego_info.get("num_lanes_opposite_direction", 0))
    ego_lane = int(ego_info.get("ego_lane_number", 0))
    # CARLA LaneChange enum: 0 NONE, 1 Right, 2 Left, 3 Both
    lane_change_flag = ego_info.get("lane_change")
    if lane_change_flag is None:
        ml = str(ego_info.get("lane_marking_left", "Broken"))
        mr = str(ego_info.get("lane_marking_right", "Broken"))
        lane_change_flag = (2 if "Broken" in ml else 0) | \
                           (1 if "Broken" in mr else 0)
    lane_change_flag = int(lane_change_flag)

    options: List[Tuple[int, str]] = []
    for lane_num in range(n_same):
        d = lane_num - ego_lane
        if d != 0:
            options.append((d, "driving"))
    extreme_right = max([lane_num - ego_lane for lane_num in range(n_same)]
                        + [0])
    if ego_info.get("parking_right"):
        extreme_right += 1
        options.append((extreme_right, "parking"))
    if ego_info.get("sidewalk_right"):
        extreme_right += 1
        options.append((extreme_right, "sidewalk"))
    extreme_left = -(ego_lane + 1)
    for k in range(n_opp):
        options.append((extreme_left - k, "driving opposite"))
    if n_opp:
        extreme_left -= n_opp
        if ego_info.get("parking_left"):
            options.append((extreme_left, "parking"))
            extreme_left -= 1
        if ego_info.get("sidewalk_left"):
            options.append((extreme_left, "sidewalk"))

    speed = float(current.get("speed", 0.0))
    max_dist = max(speed * 2 - 1, 6.0)
    out: List[Dict] = []
    for direction, lc_type in options:
        start = int(rng.randint(0, max(int(max_dist / 2), 5)))
        lo = int(speed / 2)
        hi = max(int(max_dist - start), 5)
        transition = int(rng.randint(lo, hi)) if hi > lo else hi
        offset = _lane_width_sum(ego_info, direction)
        if direction < 0:
            allowed = lane_change_flag in (2, 3)
        else:
            allowed = lane_change_flag in (1, 3)
        if "opposite" in lc_type or lc_type == "sidewalk":
            allowed = False
        side = "left" if direction < 0 else "right"
        out.append({
            "direction": direction,
            "direction_str": f"{abs(direction)} {side}",
            "type": lc_type, "allowed": allowed,
            "start": start, "transition": transition, "offset": offset,
        })
    return out


# ---------------------------------------------------------------------------
# Per-frame generation (reference process_data :134-801)
# ---------------------------------------------------------------------------

def _get_ego_info(current: Dict, boxes: Sequence[Dict]) -> Dict:
    info = {k: current[k] for k in (
        "num_lanes_same_direction", "num_lanes_opposite_direction",
        "ego_lane_number", "is_in_junction", "distance_to_junction",
        "lane_marking_left", "lane_marking_right", "lane_change",
        "lane_type_str", "parking_left", "parking_right", "sidewalk_left",
        "sidewalk_right", "left_lanes", "right_lanes",
        "traffic_light_state") if k in current}
    for b in boxes:
        if str(b.get("class", "")) == "ego_info":
            info = dict(b, **info)
    return info


def generate_alternatives(current: Dict,
                          boxes: Optional[Sequence[Dict]] = None,
                          future_measurements: Sequence[Dict] = (),
                          future_boxes: Sequence[Sequence[Dict]] = (),
                          rng: Optional[np.random.RandomState] = None,
                          templates: Optional[Dict] = None
                          ) -> Dict[str, List[Dict]]:
    """One frame -> {mode: [option dicts]} via forward simulation."""
    rng = rng or np.random.RandomState(0)
    boxes = list(boxes or [])
    speed = float(current.get("speed", 0.0))
    ego_info = _get_ego_info(current, boxes)

    route_local = M.equal_spacing_route(
        np.asarray(current["route"], float),
        num_points=max(len(current["route"]), 40))
    # full-length 1 m-spaced expert route: the CTE plausibility filter and
    # the org-route replacement both need the whole horizon (a truncated
    # route would mislabel far lane-change points as >5 m deviations)
    route_adjusted = route_local
    route_original = M.equal_spacing_route(
        np.asarray(current.get("route_original", current["route"]), float),
        num_points=max(len(current.get("route_original",
                                       current["route"])), 40))

    tracks = gt_actor_tracks(current, boxes, future_measurements,
                             future_boxes)
    walker_close = any(_is_walker_box(b)
                       and float(b.get("distance", np.linalg.norm(
                           np.asarray(b.get("position", [99, 99]),
                                      float)[:2]))) < 10
                       for b in boxes)

    # expert speed profile at 20 Hz (recorded future speeds)
    gt_speeds = _interp_rows(np.array(
        [speed] + [float(m.get("speed", speed))
                   for m in future_measurements]), N_SIM)

    rollouts: List[Dict] = []

    def add(ro: Dict, route_opt, info: Dict):
        wps = np.round(ro["waypoints"], 3)
        hit, steps = dynamic_crash_check(ro["waypoints"], ro["yaws"], tracks)
        info = dict(info, dynamic_crash=hit, dynamic_crash_timesteps=steps,
                    final_speed=ro["final_speed"], current_speed=speed)
        rollouts.append({
            "waypoints": wps.tolist(),
            "route": route_opt if isinstance(route_opt, str)
            else np.round(np.asarray(route_opt, float), 2).tolist(),
            "info": info,
        })

    # --- speed modes (reference :358-438) ---
    if rng.rand() < 0.6:
        random_ts = round(float(rng.uniform(0, 35)), 1)
    else:
        random_ts = round(float(rng.uniform(speed * 0.6, speed * 1.4)), 1)
    ro = rollout_ego(current, route_local, future_measurements,
                     target_speed=random_ts)
    add(ro, "org", {"allowed": True, "mode": "target_speed",
                    "target_speed": random_ts})

    if random_ts > 0.01:
        ro = rollout_ego(current, route_local, future_measurements,
                         target_speed=0.0)
        add(ro, "org", {"allowed": True, "mode": "stop", "target_speed": 0.0})

    faster_factor = float(rng.uniform(1.1, 1.5))
    ro = rollout_ego(current, route_local, future_measurements,
                     speeds_to_follow=faster_factor * gt_speeds)
    add(ro, "org", {"allowed": True, "mode": "faster_factor",
                    "factor": round(faster_factor, 3)})

    band = int(rng.randint(0, 3))
    throttle = float(rng.uniform(*[(0.5, 0.7), (0.7, 0.85),
                                   (0.85, 1.0)][band]))
    ro = rollout_ego(current, route_local, future_measurements,
                     desired_throttle=throttle)
    add(ro, "org", {"allowed": True, "mode": "faster",
                    "desired_throttle": round(throttle, 3), "rate": band})

    slower_factor = float(rng.uniform(0.3, 0.9))
    ro = rollout_ego(current, route_local, future_measurements,
                     speeds_to_follow=slower_factor * gt_speeds)
    add(ro, "org", {"allowed": True, "mode": "slower_factor",
                    "factor": round(slower_factor, 3)})

    if speed < 12:
        brake_p = float(rng.uniform(0.3, 0.35))
    else:
        brake_p = float(rng.uniform(0.3, 0.6))
    ro = rollout_ego(current, route_local, future_measurements,
                     brake_probability=brake_p, rng=rng)
    add(ro, "org", {"allowed": True, "mode": "slower",
                    "brake_probability": round(brake_p, 3)})

    # --- crashes (reference :446-629) ---
    for cand in select_crash_candidates(current, boxes, route_local,
                                        tracks, rng):
        crash_route = splice_crash_route(route_local, cand["position"])
        ro = rollout_ego(current, crash_route, future_measurements,
                         target_speed=cand["target_speed"])
        b = cand["box"]
        info = {"allowed": True, "mode": "crash",
                "target_speed": round(cand["target_speed"], 3),
                "crash_position": np.round(
                    np.asarray(cand["position"], float), 3).tolist(),
                "type": cand["type"]}
        for key in ("class", "name", "color_rgb", "type_id", "distance",
                    "id", "position"):
            if key in b:
                info[key] = b[key]
        add(ro, crash_route, info)

    # --- lane changes (reference :632-737) ---
    for lc in enumerate_lane_changes(current, ego_info, rng):
        lc_route = calculate_shifted_trajectory(
            route_local, lc["start"], lc["transition"], lc["offset"])
        ro = rollout_ego(current, lc_route, future_measurements)
        add(ro, lc_route, {
            "allowed": lc["allowed"], "mode": "lane_change",
            "lane_change_direction": lc["direction_str"],
            "lane_change_type": lc["type"],
            "lane_change_in_transition_amount_meters":
                (lc["start"], lc["transition"], round(lc["offset"], 2))})

    return DI.get_info(rollouts, route_adjusted, route_original, current,
                       walker_close, ego_info, rng, templates)


# ---------------------------------------------------------------------------
# Safety predicate on a candidate trajectory (kept standalone: used by tests
# and tools to label arbitrary waypoint sequences)
# ---------------------------------------------------------------------------

def _ego_yaws(waypoints: np.ndarray) -> np.ndarray:
    d = np.diff(waypoints, axis=0, prepend=waypoints[:1] * 0.0)
    yaws = np.arctan2(d[:, 1], d[:, 0])
    still = np.linalg.norm(d, axis=1) < 1e-3
    for i in range(1, len(yaws)):
        if still[i]:
            yaws[i] = yaws[i - 1]
    if len(yaws) and still[0]:
        yaws[0] = yaws[1] if len(yaws) > 1 else 0.0
    return yaws


def is_safe(waypoints: np.ndarray, boxes: Sequence[Dict],
            safety_margin: float = 0.5) -> bool:
    """OBB-forecast safety label: actors rolled forward with the kinematic
    bicycle (vehicles) / constant velocity (walkers), oriented-box SAT
    against the candidate ego trajectory (WP_DT-spaced ego positions)."""
    if not boxes:
        return True
    n = len(waypoints)
    cfg = F.ForecastConfig(frame_rate=max(int(round(1.0 / WP_DT)), 1))
    vehicles = [b for b in boxes if not _is_walker_box(b)]
    walkers = [b for b in boxes if _is_walker_box(b)]
    pred = F.forecast_vehicles(vehicles, n, near_lane_change=False, cfg=cfg,
                               dt=WP_DT)
    wpred = F.forecast_walkers(walkers, n, cfg=cfg, dt=WP_DT)

    ego_centers = np.asarray(waypoints, float)
    ego_yaws = _ego_yaws(ego_centers)
    ego_ext = np.broadcast_to(
        np.asarray(EGO_EXTENT) + safety_margin, (n, 2))
    for fc in list(pred.values()) + list(wpred.values()):
        hits = F.obb_intersect_batch(ego_centers, ego_yaws, ego_ext,
                                     fc["centers"][:n], fc["yaws"][:n],
                                     fc["extents"][:n])
        if hits.any():
            return False
    return True


# ---------------------------------------------------------------------------
# Route driver (reference process_data file IO + __main__)
# ---------------------------------------------------------------------------

def generate_route_dreamer(route_dir: str, out_root: Optional[str] = None,
                           seed: int = 0) -> int:
    """Write dreamer/NNNN.json.gz for every frame with a full recorded
    future window (FUTURE_LEN-1 frames); frames near the route end are
    skipped like the reference (:186-205)."""
    rng = np.random.RandomState(seed)
    mdir = os.path.join(route_dir, "measurements")
    bdir = os.path.join(route_dir, "boxes")
    out_dir = (os.path.join(route_dir, "dreamer") if out_root is None
               else os.path.join(out_root, os.path.basename(route_dir),
                                 "dreamer"))
    os.makedirs(out_dir, exist_ok=True)

    frames = sorted(f for f in os.listdir(mdir) if f.endswith(".json.gz"))
    cache: Dict[str, Dict] = {}

    def _load(fn):
        if fn not in cache:
            cache[fn] = M.read_json_gz(os.path.join(mdir, fn))
        return cache[fn]

    def _load_boxes(fn):
        p = os.path.join(bdir, fn)
        return M.read_json_gz(p) if os.path.isfile(p) else []

    n = 0
    for i, fn in enumerate(frames):
        future_fns = frames[i + 1:i + FUTURE_LEN]
        if len(future_fns) < FUTURE_LEN - 1:
            continue
        current = _load(fn)
        boxes = _load_boxes(fn)
        future_ms = [_load(f) for f in future_fns]
        future_bx = [_load_boxes(f) for f in future_fns]
        alts = generate_alternatives(current, boxes, future_ms, future_bx,
                                     rng)
        with gzip.open(os.path.join(out_dir, fn), "wt") as f:
            json.dump(alts, f)
        n += 1
    return n

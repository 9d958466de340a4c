"""Measurement-file loaders and label geometry (pure numpy).

Port copy of `simlingo_tpu/data/measurements.py` (`read_json_gz` :25,
`load_measurement_window` :30, `waypoints_labels` :74); the port imports
nothing of the JAX package.

Behavioral counterparts of reference `dataset_base.py`:
  * load_measurement_window  <- load_current_and_future_measurements (:359-390)
  * get_waypoints            <- get_waypoints (:785-811) incl. y/yaw augmentation
  * waypoints_1d             <- load_waypoints (:404-409)
  * equal_spacing_route      <- equal_spacing_route (:542-554)
  * augment_route / augment_target_point (rotation+translation augmentation)

Measurement schema: team_code/autopilot.py:904-1010 (pos_global, theta,
speed, target_point(_next), command/next_command, route(+_original),
augmentation_{rotation,translation}, ego_matrix, hazard flags, ...).
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def read_json_gz(path: str) -> Dict:
    with gzip.open(path, "rt", encoding="utf-8") as f:
        return json.load(f)


def load_measurement_window(route_dir: str, start: int, hist_len: int,
                            pred_len: int) -> Tuple[List[Dict], Dict, str]:
    """Load hist_len + pred_len frames; missing future frames repeat the last
    available one (reference :384-387). Returns (all, current, current_path)."""
    loaded: List[Dict] = []
    for i in range(hist_len):
        p = os.path.join(route_dir, "measurements", f"{start + i:04}.json.gz")
        loaded.append(read_json_gz(p))
    for i in range(hist_len, hist_len + pred_len):
        p = os.path.join(route_dir, "measurements", f"{start + i:04}.json.gz")
        try:
            loaded.append(read_json_gz(p))
        except FileNotFoundError:
            loaded.append(loaded[-1])
    current = loaded[hist_len - 1]
    cur_path = os.path.join(route_dir, "measurements",
                            f"{start + hist_len - 1:04}.json.gz")
    return loaded, current, cur_path


def get_waypoints(measurements: Sequence[Dict], y_augmentation: float = 0.0,
                  yaw_augmentation: float = 0.0) -> np.ndarray:
    """Future ego positions in the current frame's ego coordinates [N, 2]."""
    origin = np.array(measurements[0]["ego_matrix"])[:3]
    origin_translation = origin[:, 3:4]
    origin_rotation = origin[:, :3]

    waypoints = []
    for m in measurements:
        wp = np.array(m["ego_matrix"])[:3, 3:4]
        wp_ego = origin_rotation.T @ (wp - origin_translation)
        waypoints.append(wp_ego[:2, 0])

    aug_yaw = np.deg2rad(yaw_augmentation)
    rot = np.array([[np.cos(aug_yaw), -np.sin(aug_yaw)],
                    [np.sin(aug_yaw), np.cos(aug_yaw)]])
    trans = np.array([[0.0], [y_augmentation]])
    out = []
    for wp in waypoints:
        pos = wp[:, None]
        out.append((rot.T @ (pos - trans))[:, 0])
    return np.asarray(out)


def waypoints_labels(measurements: Sequence[Dict], hist_len: int,
                     aug_translation: float = 0.0, aug_rotation: float = 0.0
                     ) -> Dict[str, np.ndarray]:
    """Reference load_waypoints (:392-418): labels from current+future frames.

    Returns waypoints [pred_len-1, 2] (drop current & final),
    waypoints_1d [pred_len-2, 2] cumulative arc length as [d, 0] pairs.
    """
    window = measurements[hist_len - 1:]
    wps = get_waypoints(window, aug_translation, aug_rotation)
    wps_org = get_waypoints(window, 0.0, 0.0)
    d = {"waypoints": wps[1:-1], "waypoints_org": wps_org[1:-1]}
    dists = [np.linalg.norm(wps_org[i + 1] - wps_org[i])
             for i in range(len(wps_org) - 1)]
    cum = np.cumsum(dists)
    wp1d = np.array([[x, 0.0] for x in cum[:-1]]).reshape(-1, 2)
    d["waypoints_1d"] = wp1d
    return d


def rotate_translate(points: np.ndarray, y_augmentation: float,
                     yaw_augmentation: float) -> np.ndarray:
    """Apply the dataset's standard 2D augmentation to [N, 2] points."""
    aug_yaw = np.deg2rad(yaw_augmentation)
    rot = np.array([[np.cos(aug_yaw), -np.sin(aug_yaw)],
                    [np.sin(aug_yaw), np.cos(aug_yaw)]])
    trans = np.array([0.0, y_augmentation])
    return (points - trans) @ rot


def equal_spacing_route(points: np.ndarray, num_points: int = 20
                        ) -> np.ndarray:
    """Re-sample a polyline at 1 m arc-length spacing (reference :542-554)."""
    points = np.asarray(points, np.float64)
    route = np.concatenate((np.zeros_like(points[:1]), points))
    shift = np.roll(route, 1, axis=0)
    shift[0] = shift[1]
    dists = np.linalg.norm(route - shift, axis=1)
    dists = np.cumsum(dists)
    dists = dists + np.arange(len(dists)) * 1e-4
    x = np.arange(0, num_points, 1)
    return np.stack([np.interp(x, dists, route[:, 0]),
                     np.interp(x, dists, route[:, 1])], axis=1)


def route_labels(current: Dict, num_route_points: int = 20,
                 aug_translation: float = 0.0, aug_rotation: float = 0.0
                 ) -> Dict[str, np.ndarray]:
    """Reference load_route (:420-445): 1m-spaced adjusted/original routes."""
    route_adjusted = np.asarray(current["route"], np.float64)
    out = {
        "route_adjusted": equal_spacing_route(
            rotate_translate(route_adjusted, aug_translation, aug_rotation),
            num_route_points),
        "route_adjusted_org": equal_spacing_route(route_adjusted,
                                                  num_route_points),
    }
    route = np.asarray(current["route_original"], np.float64)
    route = rotate_translate(route, aug_translation, aug_rotation)
    if len(route) < num_route_points:
        pad = np.tile(route[-1], (num_route_points - len(route), 1))
        route = np.vstack([route, pad])
    else:
        route = route[:num_route_points]
    out["route"] = equal_spacing_route(route, num_route_points)
    return out


COMMAND_MAP = {
    1: "go left at the next intersection",
    2: "go right at the next intersection",
    3: "go straight at the next intersection",
    4: "follow the road",
    5: "do a lane change to the left",
    6: "do a lane change to the right",
}

# LMDrive template-bank indices per command (reference dataset_base.py:516+)
COMMAND_TEMPLATE_MAPPINGS = {
    1: [0, 2, 4, 7],
    2: [1, 3, 5, 8],
    3: [6, 9],
    4: [38, 40, 42, 43, 44, 45],
    5: [34, 36],
    6: [35, 37],
}

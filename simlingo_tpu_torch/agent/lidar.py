"""LiDAR capture utilities for the data-collection agent.

Copy of `simlingo_tpu/agent/lidar.py`.

Behavioral counterpart of reference team_code/data_agent.py:304-330
(half-sweep realignment) and :455-496 (.laz persistence via laspy):

CARLA's default LiDAR spins at 10 Hz while the simulation ticks at 20 Hz,
so each tick delivers only half a revolution; a full sweep is the union of
the last two half-sweeps with the older half transformed into the current
ego frame (the ego moved between ticks).

Persistence: `.laz` via laspy when available; this environment does not
ship laspy, so the writer transparently falls back to a compressed `.npz`
with the same payload (gated, documented -- the loader handles both).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

try:
    import laspy  # type: ignore
    HAVE_LASPY = True
except ImportError:
    laspy = None
    HAVE_LASPY = False


def relative_transform(pos_prev: np.ndarray, yaw_prev: float,
                       pos_cur: np.ndarray, yaw_cur: float) -> np.ndarray:
    """Homogeneous 2D-in-3D transform taking points from the previous ego
    frame into the current ego frame."""
    c0, s0 = np.cos(yaw_prev), np.sin(yaw_prev)
    c1, s1 = np.cos(yaw_cur), np.sin(yaw_cur)
    prev_to_world = np.array([[c0, -s0, 0, pos_prev[0]],
                              [s0, c0, 0, pos_prev[1]],
                              [0, 0, 1, 0],
                              [0, 0, 0, 1]])
    world_to_cur = np.linalg.inv(np.array([[c1, -s1, 0, pos_cur[0]],
                                           [s1, c1, 0, pos_cur[1]],
                                           [0, 0, 1, 0],
                                           [0, 0, 0, 1]]))
    return world_to_cur @ prev_to_world


def realign_half_sweeps(prev_half: Optional[np.ndarray],
                        cur_half: np.ndarray,
                        pos_prev: Optional[np.ndarray] = None,
                        yaw_prev: float = 0.0,
                        pos_cur: Optional[np.ndarray] = None,
                        yaw_cur: float = 0.0) -> np.ndarray:
    """Union of two ego-frame half-sweeps [N, 3+] with the previous half
    motion-compensated into the current frame (reference :304-330)."""
    cur_half = np.asarray(cur_half, float)
    if prev_half is None or len(prev_half) == 0:
        return cur_half
    prev = np.asarray(prev_half, float)
    if pos_prev is not None and pos_cur is not None:
        T = relative_transform(np.asarray(pos_prev, float), yaw_prev,
                               np.asarray(pos_cur, float), yaw_cur)
        xyz1 = np.concatenate([prev[:, :3],
                               np.ones((len(prev), 1))], axis=1)
        prev = np.concatenate([(T @ xyz1.T).T[:, :3], prev[:, 3:]], axis=1)
    return np.concatenate([prev, cur_half], axis=0)


def save_lidar(path_no_ext: str, points: np.ndarray) -> str:
    """Write a point cloud; .laz when laspy exists, .npz otherwise.
    Returns the written path."""
    points = np.asarray(points, np.float32)
    if HAVE_LASPY:
        header = laspy.LasHeader(point_format=0)
        header.offsets = points[:, :3].min(axis=0) if len(points) \
            else np.zeros(3)
        header.scales = np.array([0.001, 0.001, 0.001])
        las = laspy.LasData(header)
        if len(points):
            las.x, las.y, las.z = points[:, 0], points[:, 1], points[:, 2]
        path = path_no_ext + ".laz"
        las.write(path)
        return path
    path = path_no_ext + ".npz"
    np.savez_compressed(path, points=points)
    return path


def load_lidar(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        return np.load(path)["points"]
    if HAVE_LASPY:
        las = laspy.read(path)
        return np.stack([las.x, las.y, las.z], axis=1).astype(np.float32)
    raise RuntimeError(f"cannot read {path} without laspy")


# ---------------------------------------------------------------------------
# Weather shuffling (reference data_agent.py:434-453)
# ---------------------------------------------------------------------------

WEATHER_PRESETS: Tuple[Dict, ...] = (
    {"cloudiness": 5.0, "precipitation": 0.0, "sun_altitude_angle": 70.0,
     "fog_density": 0.0, "wetness": 0.0},
    {"cloudiness": 40.0, "precipitation": 0.0, "sun_altitude_angle": 45.0,
     "fog_density": 2.0, "wetness": 0.0},
    {"cloudiness": 80.0, "precipitation": 30.0, "sun_altitude_angle": 30.0,
     "fog_density": 5.0, "wetness": 40.0},
    {"cloudiness": 90.0, "precipitation": 60.0, "sun_altitude_angle": 15.0,
     "fog_density": 10.0, "wetness": 80.0},
    {"cloudiness": 20.0, "precipitation": 0.0, "sun_altitude_angle": -10.0,
     "fog_density": 3.0, "wetness": 0.0},        # night
    {"cloudiness": 60.0, "precipitation": 0.0, "sun_altitude_angle": 5.0,
     "fog_density": 40.0, "wetness": 0.0},       # fog at dusk
)


def sample_weather(rng: np.random.RandomState) -> Dict:
    """Random weather with jitter around a preset (the reference shuffles
    weather per route / periodically during collection)."""
    base = dict(WEATHER_PRESETS[rng.randint(len(WEATHER_PRESETS))])
    for k in base:
        base[k] = float(base[k] + rng.uniform(-5.0, 5.0)
                        if k != "sun_altitude_angle"
                        else base[k] + rng.uniform(-10.0, 10.0))
    base["cloudiness"] = float(np.clip(base["cloudiness"], 0, 100))
    base["precipitation"] = float(np.clip(base["precipitation"], 0, 100))
    base["fog_density"] = float(np.clip(base["fog_density"], 0, 100))
    base["wetness"] = float(np.clip(base["wetness"], 0, 100))
    return base

"""Geometry utilities: angles, frame conversions, OBB intersection, NMS.

Copy of `simlingo_tpu/utils/geometry.py`.

Behavioral counterpart of the reference's `transfuser_utils.py` grab-bag
(SURVEY.md section 2.3): normalize_angle, 2D global<->ego conversions,
oriented-bounding-box intersection (separating-axis theorem), box NMS, and
camera projection helpers (intrinsics FOV 110 / extrinsics at (-1.5, 0, 2)).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


def normalize_angle(angle: float) -> float:
    return (angle + math.pi) % (2 * math.pi) - math.pi


def rotation_2d(yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, -s], [s, c]])


def inverse_conversion_2d(point: np.ndarray, translation: np.ndarray,
                          yaw: float) -> np.ndarray:
    """Global -> ego frame (reference transfuser_utils:132-143)."""
    return rotation_2d(yaw).T @ (np.asarray(point) - np.asarray(translation))


def conversion_2d(point: np.ndarray, translation: np.ndarray,
                  yaw: float) -> np.ndarray:
    """Ego -> global frame (reference transfuser_utils:145-156)."""
    return rotation_2d(yaw) @ np.asarray(point) + np.asarray(translation)


def convert_depth(data: np.ndarray) -> np.ndarray:
    """CARLA encoded depth map [H, W, 3] (R,G,B) -> normalized depth in [0,1].

    Reference transfuser_utils.py:591-605: 24-bit depth decoded as
    (R*65536 + G*256 + B) / (2^24 - 1), clipped to 50 m (0.05 of the 1 km
    range) and rescaled by 20 so the saved map lies in [0, 1]. The data
    agent stores it at 8 bit (reference data_agent.py:285-290).
    """
    data = np.asarray(data, np.float32)
    normalized = data @ np.array([65536.0, 256.0, 1.0], np.float32)
    normalized /= (256.0 ** 3 - 1)
    return np.clip(normalized, 0.0, 0.05) * 20.0


def obb_corners(center: np.ndarray, yaw: float,
                extent: Tuple[float, float]) -> np.ndarray:
    """4 corners of an oriented box, extent = (half_len, half_wid)."""
    l, w = extent
    local = np.array([[l, w], [l, -w], [-l, -w], [-l, w]])
    return local @ rotation_2d(yaw).T + np.asarray(center)


def obb_intersect(c1, yaw1, ext1, c2, yaw2, ext2) -> bool:
    """Separating-axis test between two oriented boxes
    (reference transfuser_utils check_obb_intersection)."""
    p1 = obb_corners(np.asarray(c1), yaw1, ext1)
    p2 = obb_corners(np.asarray(c2), yaw2, ext2)
    for poly in (p1, p2):
        for i in range(4):
            edge = poly[(i + 1) % 4] - poly[i]
            axis = np.array([-edge[1], edge[0]])
            a1 = p1 @ axis
            a2 = p2 @ axis
            if a1.max() < a2.min() or a2.max() < a1.min():
                return False
    return True


def iou_aabb(box1: np.ndarray, box2: np.ndarray) -> float:
    """Axis-aligned IoU; boxes as [x1, y1, x2, y2]."""
    xa = max(box1[0], box2[0])
    ya = max(box1[1], box2[1])
    xb = min(box1[2], box2[2])
    yb = min(box1[3], box2[3])
    inter = max(0.0, xb - xa) * max(0.0, yb - ya)
    a1 = (box1[2] - box1[0]) * (box1[3] - box1[1])
    a2 = (box2[2] - box2[0]) * (box2[3] - box2[1])
    return inter / max(a1 + a2 - inter, 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray,
        iou_threshold: float = 0.5) -> List[int]:
    """Greedy NMS over [N, 4] AABBs (reference transfuser_utils NMS)."""
    order = np.argsort(scores)[::-1]
    keep: List[int] = []
    while len(order):
        i = int(order[0])
        keep.append(i)
        rest = order[1:]
        order = np.asarray([j for j in rest
                            if iou_aabb(boxes[i], boxes[j]) < iou_threshold])
    return keep


def camera_intrinsics(width: int = 1024, height: int = 512,
                      fov_deg: float = 110.0) -> np.ndarray:
    """Pinhole K (reference utils/projection.py, FOV 110)."""
    f = width / (2.0 * math.tan(math.radians(fov_deg) / 2.0))
    return np.array([[f, 0.0, width / 2.0],
                     [0.0, f, height / 2.0],
                     [0.0, 0.0, 1.0]])


def camera_extrinsics(pos=(-1.5, 0.0, 2.0), rot=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Camera-to-ego 4x4 (reference camera at x=-1.5, z=2.0)."""
    roll, pitch, yaw = (math.radians(r) for r in rot)
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    R = np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]])
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = pos
    return M


def project_points(points_ego: np.ndarray, K: Optional[np.ndarray] = None,
                   extrinsics: Optional[np.ndarray] = None) -> np.ndarray:
    """Ego-frame 3D points -> image pixels [N, 2] (z<=0 rows -> nan)."""
    K = camera_intrinsics() if K is None else K
    E = camera_extrinsics() if extrinsics is None else extrinsics
    pts = np.asarray(points_ego, float).reshape(-1, 3)
    cam = (np.linalg.inv(E) @ np.concatenate(
        [pts, np.ones((len(pts), 1))], 1).T)[:3].T
    # ego (x fwd, y right, z up) -> camera (x right, y down, z fwd)
    cam_xyz = np.stack([cam[:, 1], -cam[:, 2], cam[:, 0]], 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = (K @ cam_xyz.T).T
        uv = uv[:, :2] / uv[:, 2:3]
    uv[cam_xyz[:, 2] <= 0.1] = np.nan
    return uv

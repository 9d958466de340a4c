"""Synthetic pinhole camera for the microsim.

Copy of `simlingo_tpu/sim/camera.py`.

Renders the world through the SAME calibrated camera model the agent and
label generators use (utils/geometry.py: FOV 110, camera at (-1.5, 0, 2) on
the ego -- reference dataset_generation projection constants): flat-shaded
road surface, lane markings, actor cuboids with painter's-algorithm depth
ordering, traffic-light discs, sky gradient. Also emits the semantic and
depth maps the SAVE_TF_LABELS collection path saves (reference
team_code/data_agent.py semantics/depth sensors).

Pixel realism is explicitly out of scope (documented in
docs/COMPONENT_MAP.md): the renderer's job is geometric consistency --
every projected waypoint, box, and lane in the generated labels lands on
the matching pixels of these frames.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simlingo_tpu_torch.sim.actors import Actor
from simlingo_tpu_torch.sim.world import SimWorld
from simlingo_tpu_torch.utils.geometry import (camera_extrinsics,
                                         camera_intrinsics)

# CARLA semantic tags (reference doc: CityScapes palette subset used by
# team_code/data_agent.py semantic sensor)
SEM_ROAD, SEM_LINE, SEM_VEHICLE, SEM_WALKER, SEM_LIGHT, SEM_STATIC = (
    1, 24, 14, 12, 7, 20)

_COLORS = {
    "sky_top": (70, 110, 160), "sky_bot": (150, 170, 190),
    "ground": (90, 105, 80), "road": (60, 60, 66),
    "marking_white": (210, 210, 210), "marking_yellow": (200, 180, 60),
    "walker": (190, 120, 90), "static": (230, 140, 40),
    "pole": (40, 40, 40),
}


def _vehicle_color(actor: Actor) -> Tuple[int, int, int]:
    try:
        r, g, b = (int(v) for v in actor.color.split(","))
        return (r, g, b)
    except Exception:
        return (120, 120, 130)


class Camera:
    """Ego-mounted RGB + semantics + depth renderer."""

    def __init__(self, width: int = 1024, height: int = 512,
                 fov_deg: float = 110.0,
                 pos: Tuple[float, float, float] = (-1.5, 0.0, 2.0),
                 max_range: float = 80.0):
        self.width, self.height = width, height
        self.K = camera_intrinsics(width, height, fov_deg)
        self.E_inv = np.linalg.inv(camera_extrinsics(pos))
        self.mount = tuple(pos)
        self.max_range = max_range

    # -- projection ----------------------------------------------------------
    def _to_cam(self, pts_world: np.ndarray, ego_pos: np.ndarray,
                ego_yaw: float) -> np.ndarray:
        """World [N, 3] -> camera frame [N, 3] (x right, y down, z fwd)."""
        c, s = math.cos(ego_yaw), math.sin(ego_yaw)
        rel = np.asarray(pts_world, float).reshape(-1, 3).copy()
        rel[:, :2] -= ego_pos[None, :2]
        ego = np.stack([c * rel[:, 0] + s * rel[:, 1],
                        -s * rel[:, 0] + c * rel[:, 1], rel[:, 2]], 1)
        cam = (self.E_inv @ np.concatenate(
            [ego, np.ones((len(ego), 1))], 1).T)[:3].T
        return np.stack([cam[:, 1], -cam[:, 2], cam[:, 0]], 1)

    def _project_poly(self, cam_xyz: np.ndarray,
                      near: float = 0.3) -> Optional[np.ndarray]:
        """Camera-frame polygon -> integer pixel polygon, near-clipped."""
        z = cam_xyz[:, 2]
        if (z <= near).all():
            return None
        pts = _clip_near(cam_xyz, near)
        if len(pts) < 3:
            return None
        uv = (self.K @ pts.T).T
        uv = uv[:, :2] / uv[:, 2:3]
        return np.round(uv).astype(np.int32)

    # -- rendering -----------------------------------------------------------
    def render(self, world: SimWorld, ego: Optional[Actor] = None,
               with_labels: bool = False,
               pose: Optional[Tuple[np.ndarray, float]] = None
               ) -> Dict[str, np.ndarray]:
        """pose: optional (position, yaw) camera-mount override (pose-
        augmented second camera); `ego` is still excluded from drawing."""
        import cv2

        ego = ego or world.ego
        pos, yaw = (ego.position, ego.yaw) if pose is None else pose
        h, w = self.height, self.width
        rgb = np.zeros((h, w, 3), np.uint8)
        sem = np.zeros((h, w), np.uint8)
        depth = np.full((h, w), np.inf, np.float32)

        # sky gradient + ground
        horizon = h // 2
        grad = np.linspace(0.0, 1.0, horizon)[:, None]
        top = np.array(_COLORS["sky_top"], float)
        bot = np.array(_COLORS["sky_bot"], float)
        rgb[:horizon] = (top[None, None] * (1 - grad[:, :, None])
                         + bot[None, None] * grad[:, :, None]).astype(
                             np.uint8)
        rgb[horizon:] = _COLORS["ground"]
        # true ground-plane depth per row: planar z = f * cam_height / (v
        # - cy) for a level camera (CARLA depth is planar-z metric)
        f, cy = self.K[1, 1], self.K[1, 2]
        rows = np.arange(horizon, h, dtype=np.float64)
        cam_h = float(self.mount[2])
        with np.errstate(divide="ignore"):
            ground_z = np.where(rows > cy, f * cam_h / (rows - cy),
                                self.max_range)
        depth[horizon:] = np.minimum(ground_z, self.max_range)[:, None]

        # road surface: lane quads (far strips first is irrelevant --
        # the ground plane never occludes itself at z=0)
        for lane in world.map.lanes.values():
            self._draw_lane(cv2, rgb, sem, depth, lane, pos, yaw)
        for lane in world.map.lanes.values():
            self._draw_markings(cv2, rgb, sem, lane, pos, yaw)

        # actors far -> near (painter's algorithm)
        actors = [a for a in world.actors if a.alive and a is not ego]
        actors.sort(key=lambda a: -np.linalg.norm(a.position - pos))
        for actor in actors:
            if np.linalg.norm(actor.position - pos) > self.max_range:
                continue
            self._draw_actor(cv2, rgb, sem, depth, actor, pos, yaw)

        for light in world.lights:
            self._draw_light(cv2, rgb, sem, light, pos, yaw)

        out = {"rgb": rgb}
        if with_labels:
            out["semantics"] = sem
            out["depth"] = np.minimum(depth, self.max_range)
        return out

    def _draw_lane(self, cv2, rgb, sem, depth, lane, pos, yaw) -> None:
        c = lane.center
        keep = np.linalg.norm(c - pos[None], axis=1) < self.max_range
        if not keep.any():
            return
        i0, i1 = np.argmax(keep), len(keep) - np.argmax(keep[::-1])
        c = c[max(i0 - 1, 0):i1 + 1]
        if len(c) < 2:
            return
        tang = np.gradient(c, axis=0)
        tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True),
                           1e-9)
        normals = np.stack([-tang[:, 1], tang[:, 0]], 1)
        half = lane.width / 2.0
        left = np.concatenate([c + half * normals,
                               np.zeros((len(c), 1))], 1)
        right = np.concatenate([c - half * normals,
                                np.zeros((len(c), 1))], 1)
        # draw in ~12-point strips to keep polygons planar after clipping
        step = 12
        for j in range(0, len(c) - 1, step):
            k = min(j + step + 1, len(c))
            poly_w = np.concatenate([left[j:k], right[j:k][::-1]], 0)
            cam = self._to_cam(poly_w, pos, yaw)
            px = self._project_poly(cam)
            if px is None:
                continue
            cv2.fillPoly(rgb, [px], _COLORS["road"])
            cv2.fillPoly(sem, [px], SEM_ROAD)

    def _draw_markings(self, cv2, rgb, sem, lane, pos, yaw) -> None:
        c = lane.center
        keep = np.linalg.norm(c - pos[None], axis=1) < self.max_range
        if not keep.any():
            return
        i0, i1 = np.argmax(keep), len(keep) - np.argmax(keep[::-1])
        c = c[max(i0 - 1, 0):i1 + 1]
        if len(c) < 2:
            return
        tang = np.gradient(c, axis=0)
        tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True),
                           1e-9)
        normals = np.stack([-tang[:, 1], tang[:, 0]], 1)
        half = lane.width / 2.0
        for side, marking, color_name in (
                (+1, lane.marking_left, lane.marking_left_color),
                (-1, lane.marking_right, lane.marking_right_color)):
            edge = c + side * half * normals
            color = (_COLORS["marking_yellow"]
                     if color_name.lower() == "yellow"
                     else _COLORS["marking_white"])
            dash = 4 if marking == "Broken" else len(edge)
            for j in range(0, len(edge) - 1, dash + (2 if dash < len(edge)
                                                     else 0)):
                k = min(j + dash, len(edge) - 1)
                seg = np.concatenate([edge[j:k + 1],
                                      np.zeros((k + 1 - j, 1))], 1)
                cam = self._to_cam(seg, pos, yaw)
                px = _project_polyline(self.K, cam)
                if px is not None:
                    cv2.polylines(rgb, [px], False, color, 2)
                    cv2.polylines(sem, [px], False, SEM_LINE, 2)

    def _draw_actor(self, cv2, rgb, sem, depth, actor, pos, yaw) -> None:
        corners = actor.corners()
        height = {"walker": 1.8, "static": 0.8}.get(actor.base_type, 1.6)
        bottom = np.concatenate([corners, np.zeros((4, 1))], 1)
        top = np.concatenate([corners, np.full((4, 1), height)], 1)
        cam_b = self._to_cam(bottom, pos, yaw)
        cam_t = self._to_cam(top, pos, yaw)
        dist = float(np.linalg.norm(actor.position - pos))
        base_color = {"walker": _COLORS["walker"],
                      "static": _COLORS["static"]}.get(
                          actor.base_type, _vehicle_color(actor))
        tag = {"walker": SEM_WALKER,
               "static": SEM_STATIC}.get(actor.base_type, SEM_VEHICLE)
        # four side faces + roof, simple per-face shading
        faces = [np.array([cam_b[i], cam_b[(i + 1) % 4],
                           cam_t[(i + 1) % 4], cam_t[i]])
                 for i in range(4)] + [cam_t]
        shade = [0.85, 0.7, 0.55, 0.7, 1.0]
        for face, sh in zip(faces, shade):
            px = self._project_poly(face)
            if px is None:
                continue
            col = tuple(int(v * sh) for v in base_color)
            cv2.fillPoly(rgb, [px], col)
            cv2.fillPoly(sem, [px], int(tag))
            mask = np.zeros(rgb.shape[:2], np.uint8)
            cv2.fillPoly(mask, [px], 1)
            depth[mask > 0] = np.minimum(depth[mask > 0], dist)

    def _draw_light(self, cv2, rgb, sem, light, pos, yaw) -> None:
        spot = light.spot
        if np.linalg.norm(spot.position - pos) > self.max_range:
            return
        # pole beside the stop line, head at 4 m
        lane_n = np.array([-math.sin(spot.yaw), math.cos(spot.yaw)])
        base2 = spot.position - lane_n * 3.0
        base = np.array([[base2[0], base2[1], 0.0],
                         [base2[0], base2[1], 4.0]])
        cam = self._to_cam(base, pos, yaw)
        px = _project_polyline(self.K, cam)
        if px is None:
            return
        cv2.polylines(rgb, [px], False, _COLORS["pole"], 3)
        head = self._to_cam(base[1:2], pos, yaw)
        if head[0, 2] > 0.3:
            uv = (self.K @ head.T).T
            u, v = uv[0, :2] / uv[0, 2]
            col = {"red": (220, 40, 40), "yellow": (230, 200, 40),
                   "green": (40, 200, 80)}[light.state]
            r = max(int(60.0 / head[0, 2]), 2)
            cv2.circle(rgb, (int(u), int(v)), r, col, -1)
            cv2.circle(sem, (int(u), int(v)), r, SEM_LIGHT, -1)


def _clip_near(cam_xyz: np.ndarray, near: float) -> np.ndarray:
    """Sutherland-Hodgman clip of a polygon against z = near."""
    out: List[np.ndarray] = []
    n = len(cam_xyz)
    for i in range(n):
        a, b = cam_xyz[i], cam_xyz[(i + 1) % n]
        ain, bin_ = a[2] > near, b[2] > near
        if ain:
            out.append(a)
        if ain != bin_:
            t = (near - a[2]) / (b[2] - a[2])
            out.append(a + t * (b - a))
    return np.asarray(out) if out else np.zeros((0, 3))


def _project_polyline(K: np.ndarray, cam_xyz: np.ndarray,
                      near: float = 0.3) -> Optional[np.ndarray]:
    """Near-clipped polyline -> int pixel coords (None if fully behind)."""
    pts: List[np.ndarray] = []
    for i in range(len(cam_xyz) - 1):
        a, b = cam_xyz[i], cam_xyz[i + 1]
        if a[2] <= near and b[2] <= near:
            continue
        aa, bb = a.copy(), b.copy()
        if aa[2] <= near:
            t = (near - aa[2]) / (bb[2] - aa[2])
            aa = aa + t * (bb - aa)
        elif bb[2] <= near:
            t = (near - bb[2]) / (aa[2] - bb[2])
            bb = bb + t * (aa - bb)
        if not pts or not np.allclose(pts[-1], aa):
            pts.append(aa)
        pts.append(bb)
    if len(pts) < 2:
        return None
    arr = np.asarray(pts)
    uv = (K @ arr.T).T
    uv = uv[:, :2] / uv[:, 2:3]
    return np.round(uv).astype(np.int32)

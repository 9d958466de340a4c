"""BEV semantic-map rendering for data-collection labels.

Copy of `simlingo_tpu/labels/bev_renderer.py`.

Behavioral counterpart of reference `team_code/birds_eye_view/chauffeurnet.py`
(ObsManager): a multi-channel top-down rasterization around the ego --
road/route masks, ego box, other vehicles, pedestrians, traffic-light stop
lines -- written alongside the other sensors during collection.

Channels: 0 route, 1 ego, 2 vehicles, 3 walkers, 4 red-light lines,
5 static obstacles, 6 road (drivable area), 7 lane boundaries.

Road/lane rasters (channels 6-7) mirror the reference's HD-map layers
(chauffeurnet renders the CARLA road layout): the plugin passes the map's
drivable-area polygons / lane markings when CARLA is live; offline they are
approximated as a lane band around the dense route.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CHANNELS = ("route", "ego", "vehicle", "walker", "red_light", "static",
            "road", "lane_boundary")


class BEVRenderer:
    def __init__(self, size_px: int = 192, meters_range: float = 38.4,
                 ego_forward_offset: float = 0.25):
        """size_px x size_px raster covering meters_range; the ego sits
        ego_forward_offset of the way up from the bottom edge."""
        self.size = size_px
        self.range = meters_range
        self.px_per_m = size_px / meters_range
        self.ego_row = int(size_px * (1 - ego_forward_offset))

    def world_to_px(self, points_ego: np.ndarray) -> np.ndarray:
        """Ego-frame (x fwd, y right) [N, 2] -> raster (row, col) int."""
        pts = np.asarray(points_ego, float).reshape(-1, 2)
        rows = self.ego_row - pts[:, 0] * self.px_per_m
        cols = self.size / 2 + pts[:, 1] * self.px_per_m
        return np.stack([rows, cols], 1).round().astype(int)

    def _draw_box(self, bev: np.ndarray, channel: int, center: np.ndarray,
                  yaw: float, extent: Tuple[float, float]) -> None:
        import cv2
        l, w = extent
        corners = np.array([[l, w], [l, -w], [-l, -w], [-l, w]]) / 2
        rot = np.array([[np.cos(yaw), -np.sin(yaw)],
                        [np.sin(yaw), np.cos(yaw)]])
        pts = (corners @ rot.T) + np.asarray(center[:2])
        px = self.world_to_px(pts)[:, ::-1]  # cv2 wants (x=col, y=row)
        canvas = np.ascontiguousarray(bev[:, :, channel])
        cv2.fillPoly(canvas, [px.astype(np.int32)], 1.0)
        bev[:, :, channel] = canvas

    def _draw_polyline(self, bev: np.ndarray, channel: int,
                       points: np.ndarray, width_m: float = 1.0) -> None:
        import cv2
        px = self.world_to_px(points)[:, ::-1].astype(np.int32)
        canvas = np.ascontiguousarray(bev[:, :, channel])
        cv2.polylines(canvas, [px], False, 1.0,
                      max(int(width_m * self.px_per_m), 1))
        bev[:, :, channel] = canvas

    def render(self, route: Optional[np.ndarray] = None,
               vehicles: Sequence[Dict] = (), walkers: Sequence[Dict] = (),
               red_light_lines: Sequence[np.ndarray] = (),
               statics: Sequence[Dict] = (),
               ego_extent: Tuple[float, float] = (4.9, 2.1),
               road_polygons: Sequence[np.ndarray] = (),
               lane_boundaries: Sequence[np.ndarray] = (),
               lane_width: float = 3.5) -> np.ndarray:
        """-> [size, size, 8] float32 in [0, 1].

        road_polygons / lane_boundaries: ego-frame HD-map geometry (from the
        CARLA map when live). Without them the road channel falls back to a
        lane band around the route and the boundaries to its edges.
        """
        import cv2
        bev = np.zeros((self.size, self.size, len(CHANNELS)), np.float32)
        # HD-map channels first (background layers)
        if road_polygons:
            canvas = np.ascontiguousarray(bev[:, :, 6])
            for poly in road_polygons:
                px = self.world_to_px(np.asarray(poly))[:, ::-1]
                cv2.fillPoly(canvas, [px.astype(np.int32)], 1.0)
            bev[:, :, 6] = canvas
        elif route is not None and len(route) >= 2:
            self._draw_polyline(bev, 6, route, width_m=lane_width)
        if lane_boundaries:
            for line in lane_boundaries:
                self._draw_polyline(bev, 7, np.asarray(line), width_m=0.3)
        elif route is not None and len(route) >= 2:
            # approximate boundaries as the route band edges
            r = np.asarray(route, float)
            tang = np.gradient(r, axis=0)
            tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True),
                               1e-9)
            normal = np.stack([-tang[:, 1], tang[:, 0]], axis=1)
            half = lane_width / 2.0
            self._draw_polyline(bev, 7, r + half * normal, width_m=0.3)
            self._draw_polyline(bev, 7, r - half * normal, width_m=0.3)
        if route is not None and len(route) >= 2:
            self._draw_polyline(bev, 0, route, width_m=2.0)
        self._draw_box(bev, 1, np.zeros(2), 0.0, ego_extent)
        for v in vehicles:
            self._draw_box(bev, 2, np.asarray(v["position"][:2]),
                           float(v.get("yaw", 0.0)),
                           tuple(v.get("extent", (4.5, 2.0))))
        for w in walkers:
            self._draw_box(bev, 3, np.asarray(w["position"][:2]),
                           float(w.get("yaw", 0.0)),
                           tuple(w.get("extent", (0.6, 0.6))))
        for line in red_light_lines:
            self._draw_polyline(bev, 4, np.asarray(line), width_m=0.5)
        for s in statics:
            self._draw_box(bev, 5, np.asarray(s["position"][:2]),
                           float(s.get("yaw", 0.0)),
                           tuple(s.get("extent", (1.0, 1.0))))
        return bev

    def to_rgb(self, bev: np.ndarray) -> np.ndarray:
        """Debug visualization: channels -> colors."""
        colors = np.array([
            [80, 80, 80],     # route
            [255, 255, 255],  # ego
            [0, 120, 255],    # vehicles
            [255, 80, 80],    # walkers
            [255, 0, 0],      # red light
            [160, 160, 0],    # static
            [40, 40, 40],     # road
            [200, 200, 200],  # lane boundary
        ], np.float32)
        img = np.zeros((bev.shape[0], bev.shape[1], 3), np.float32)
        for c in range(bev.shape[2]):
            img = np.maximum(img, bev[:, :, c:c + 1] * colors[c])
        return img.astype(np.uint8)


# ---------------------------------------------------------------------------
# ChauffeurNet-style renderer (reference team_code/birds_eye_view/
# chauffeurnet.py ObsManager): semantic CLASS map + per-actor-type history
# masks + tinted RGB debug rendering. Same class table as the reference
# (chauffeurnet.py:281-290):
#   0 unlabeled, 1 road, 2 sidewalk, 3 lane marking, 4 broken lane marking,
#   5 stop sign, 6 green light, 7 yellow light, 8 red light, 9 vehicle,
#   10 walker
# Inputs are ego-frame geometry dicts (the CARLA plugin converts world ->
# ego; offline tests synthesize them), so the renderer itself is
# simulator-independent -- the reference warps a prerendered world-frame
# HD map instead, which needs the CARLA map server.
# ---------------------------------------------------------------------------

SEMANTIC_CLASSES = ("unlabeled", "road", "sidewalk", "lane_marking",
                    "lane_marking_broken", "stop_sign", "tl_green",
                    "tl_yellow", "tl_red", "vehicle", "walker")

_RENDER_COLORS = {
    "road": (46, 52, 54),            # COLOR_ALUMINIUM_5
    "sidewalk": (128, 128, 128),     # COLOR_GREY
    "lane_marking": (255, 0, 255),   # COLOR_MAGENTA
    "lane_marking_broken": (255, 140, 255),
    "stop_sign": (160, 160, 0),      # COLOR_YELLOW_2
    "tl_green": (0, 255, 0),
    "tl_yellow": (255, 255, 0),
    "tl_red": (255, 0, 0),
    "vehicle": (0, 0, 255),
    "walker": (0, 255, 255),
    "ego": (255, 255, 255),
}


def tint(color: Tuple[int, int, int], factor: float) -> Tuple[int, int, int]:
    """Reference chauffeurnet.tint: fade toward white for older history."""
    return tuple(min(int(c + (255 - c) * factor), 255) for c in color)


class ChauffeurNetRenderer:
    """History-aware multi-channel BEV (reference ObsManager).

    history_idx indexes the tick queue like the reference's (e.g.
    [-16, -11, -6, -1]: 4 snapshots ending at the current tick). Masks
    output is [3 + 3*len(history_idx), W, W]: road/sidewalk/lane-all
    static channels + per-history vehicle/walker/light-or-stop channels
    (the reference's _masks_channels layout).
    """

    def __init__(self, width_px: int = 192, pixels_per_meter: float = 5.0,
                 pixels_ev_to_bottom: int = 40,
                 history_idx: Sequence[int] = (-16, -11, -6, -1),
                 scale_bbox: bool = True,
                 ego_extent: Tuple[float, float] = (4.9, 2.1)):
        from collections import deque
        self.width = width_px
        self.ppm = pixels_per_meter
        self.ev_bottom = pixels_ev_to_bottom
        self.history_idx = list(history_idx)
        self.scale_bbox = scale_bbox
        self.ego_extent = ego_extent
        maxlen = max(max(history_idx) + 1, -min(history_idx))
        self._history = deque(maxlen=maxlen)
        self._raster = BEVRenderer(
            size_px=width_px, meters_range=width_px / pixels_per_meter,
            ego_forward_offset=pixels_ev_to_bottom / width_px)

    # -- mask rasterizers (ego frame: x fwd, y right) -----------------------
    def _boxes_mask(self, actors: Sequence[Dict], min_extent: float,
                    scale: float) -> np.ndarray:
        m = np.zeros((self.width, self.width, 1), np.float32)
        for a in actors:
            ext = np.asarray(a.get("extent", (2.0, 1.0)), float) * scale
            # reference scales bboxes and floors tiny ones at 0.8 m
            ext = np.maximum(ext, min_extent)
            self._raster._draw_box(m, 0, np.asarray(a["position"][:2]),
                                   float(a.get("yaw", 0.0)),
                                   (2 * ext[0], 2 * ext[1]))
        return m[:, :, 0] > 0

    def _lines_mask(self, lines: Sequence[np.ndarray],
                    width_m: float = 1.2) -> np.ndarray:
        m = np.zeros((self.width, self.width, 1), np.float32)
        for line in lines:
            self._raster._draw_polyline(m, 0, np.asarray(line), width_m)
        return m[:, :, 0] > 0

    def _polys_mask(self, polys: Sequence[np.ndarray]) -> np.ndarray:
        import cv2
        m = np.zeros((self.width, self.width), np.float32)
        for poly in polys:
            px = self._raster.world_to_px(np.asarray(poly))[:, ::-1]
            cv2.fillPoly(m, [px.astype(np.int32)], 1.0)
        return m > 0

    # -- main entry ---------------------------------------------------------
    def observe(self, vehicles: Sequence[Dict] = (),
                walkers: Sequence[Dict] = (),
                tl_green: Sequence[np.ndarray] = (),
                tl_yellow: Sequence[np.ndarray] = (),
                tl_red: Sequence[np.ndarray] = (),
                stops: Sequence[Dict] = (),
                road_polygons: Sequence[np.ndarray] = (),
                sidewalk_polygons: Sequence[np.ndarray] = (),
                lane_markings: Sequence[np.ndarray] = (),
                lane_markings_broken: Sequence[np.ndarray] = (),
                render_rgb: bool = False) -> Dict[str, np.ndarray]:
        """One tick -> {'bev_semantic_classes' [W, W] uint8,
        'masks' [3 + 3*H, W, W] uint8, 'rendered' [W, W, 3] uint8 (opt)}.

        Dynamic actors go through the history queue; traffic lights are
        stop-line polylines per state (reference get_stopline_vtx)."""
        veh_scale = 1.0 if self.scale_bbox else 1.0
        wlk_scale = 2.0 if self.scale_bbox else 1.0
        min_ext = 0.8 if self.scale_bbox else 0.0
        self._history.append((
            self._boxes_mask(vehicles, min_ext, veh_scale),
            self._boxes_mask(walkers, min_ext, wlk_scale),
            self._lines_mask(tl_green), self._lines_mask(tl_yellow),
            self._lines_mask(tl_red),
            self._boxes_mask(stops, min_ext, 1.0),
        ))

        road = self._polys_mask(road_polygons)
        sidewalk = self._polys_mask(sidewalk_polygons)
        lane_all = self._lines_mask(lane_markings, width_m=0.3)
        lane_broken = self._lines_mask(lane_markings_broken, width_m=0.3)

        qsize = len(self._history)
        hist = [self._history[max(i, -qsize)] for i in self.history_idx]
        veh_h, wlk_h, tlg_h, tly_h, tlr_h, stop_h = zip(*hist)

        # semantic class map from the CURRENT tick (reference c_all)
        c = np.zeros((self.width, self.width), np.uint8)
        c[road] = 1
        c[sidewalk] = 2
        c[lane_all] = 3
        c[lane_broken] = 4
        c[stop_h[-1]] = 5
        c[tlg_h[-1]] = 6
        c[tly_h[-1]] = 7
        c[tlr_h[-1]] = 8
        c[veh_h[-1]] = 9
        c[wlk_h[-1]] = 10

        # mask stack: 3 static + 3 per history step (vehicle/walker/
        # light+stop union) -- reference _masks_channels = 3 + 3*len(h)
        masks = [road, sidewalk, lane_all | lane_broken]
        for i in range(len(self.history_idx)):
            masks.append(veh_h[i])
            masks.append(wlk_h[i])
            masks.append(tlg_h[i] | tly_h[i] | tlr_h[i] | stop_h[i])
        out = {
            "bev_semantic_classes": c,
            "masks": (np.stack(masks) * 255).astype(np.uint8),
        }
        if render_rgb:
            img = np.zeros((self.width, self.width, 3), np.uint8)
            img[road] = _RENDER_COLORS["road"]
            img[sidewalk] = _RENDER_COLORS["sidewalk"]
            img[lane_all] = _RENDER_COLORS["lane_marking"]
            img[lane_broken] = _RENDER_COLORS["lane_marking_broken"]
            h_len = len(self.history_idx) - 1
            for i in range(len(self.history_idx)):
                f = (h_len - i) * 0.2
                img[stop_h[i]] = tint(_RENDER_COLORS["stop_sign"], f)
                img[tlg_h[i]] = tint(_RENDER_COLORS["tl_green"], f)
                img[tly_h[i]] = tint(_RENDER_COLORS["tl_yellow"], f)
                img[tlr_h[i]] = tint(_RENDER_COLORS["tl_red"], f)
            for i in range(len(self.history_idx)):
                f = (h_len - i) * 0.2
                img[veh_h[i]] = tint(_RENDER_COLORS["vehicle"], f)
                img[wlk_h[i]] = tint(_RENDER_COLORS["walker"], f)
            ego = self._boxes_mask(
                [{"position": (0.0, 0.0), "yaw": 0.0,
                  "extent": (self.ego_extent[0] / 2,
                             self.ego_extent[1] / 2)}], 0.0, 1.0)
            img[ego] = _RENDER_COLORS["ego"]
            out["rendered"] = img
        return out

    def clean(self) -> None:
        self._history.clear()


def render_bev(record: Dict, boxes: Sequence[Dict],
               renderer: Optional[BEVRenderer] = None) -> np.ndarray:
    """Convenience: one measurement record + GT boxes -> BEV raster
    (the data collector's per-frame label, reference chauffeurnet path)."""
    r = renderer or BEVRenderer()
    def _is(b, *kinds):
        c = str(b.get("class", b.get("type_id", "")))
        return any(k in c for k in kinds)
    vehicles = [b for b in boxes if _is(b, "vehicle", "car")
                and not _is(b, "static")]
    walkers = [b for b in boxes if _is(b, "walker", "pedestrian")]
    statics = [b for b in boxes if _is(b, "static", "construction",
                                       "warning")]
    route = np.asarray(record.get("route", []), float)
    return r.render(route=route if len(route) >= 2 else None,
                    vehicles=vehicles, walkers=walkers, statics=statics)

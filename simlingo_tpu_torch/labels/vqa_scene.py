"""Scene assembly + object naming for DriveLM-CARLA graph VQA.

Copy of `simlingo_tpu/labels/vqa_scene.py`.

Behavioral counterpart of the scene-side helpers of reference
`dataset_generation/language_labels/drivelm/carla_vqa_generator.py`
(:2255-2315 actor categorization, :2120-2210 vehicle naming) and
`dataset_generation/language_labels/utils.py` (project_all_corners :131,
should_consider_vehicle :208, number_to_word :277, a_or_an :265).

Everything degrades gracefully when a field the CARLA collector would
record (num_points, lane ids, road topology) is absent: geometric
fallbacks are derived from position/yaw so the generator also works on
synthetic frames and the repo's lighter box schema
(`agent/carla_data_agent.py:_gather_actors`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

CAM_W, CAM_H = 1024, 512

NUMBER_WORDS = {0: "zero", 1: "one", 2: "two", 3: "three", 4: "four",
                5: "five", 6: "six", 7: "seven", 8: "eight", 9: "nine",
                10: "ten"}


def number_to_word(n: int) -> str:
    return NUMBER_WORDS.get(int(n), str(int(n)))


def a_or_an(word: str) -> str:
    return "an" if word[:1].lower() in "aeiou" else "a"


# ---------------------------------------------------------------------------
# Vehicle naming (reference carla_vqa_generator.py:2157-2196 + :771-789)
# ---------------------------------------------------------------------------

_SPECIAL_TYPES = (
    ("firetruck", "firetruck"), ("police", "police car"),
    ("ambulance", "ambulance"), ("jeep", "jeep"), ("micro", "small car"),
    ("nissan.patrol", "SUV"), ("european_hgv", "HGV"),
    ("sprinter", "sprinter"),
)

_BASE_TYPE_HINTS = {
    "crossbike": "bicycle", "omafiets": "bicycle", "century": "bicycle",
    "diamondback": "bicycle", "carlacola": "truck", "cybertruck": "truck",
    "t2": "van", "bus": "bus", "fusorosa": "bus", "yamaha": "motorcycle",
    "vespa": "motorcycle", "kawasaki": "motorcycle", "harley": "motorcycle",
    "ninja": "motorcycle", "truck": "truck",
}

# special CARLA paint RGBs whose color_name is wrong in the blueprint
# library (reference get_vehicle_color :774-789)
_RGB_REMAP = {
    (0, 28, 0): "dark green", (12, 42, 12): "dark green",
    (211, 142, 0): "yellow", (145, 255, 181): "blue", (215, 88, 0): "orange",
}


def vehicle_type_name(box: Dict) -> str:
    tid = str(box.get("type_id", "")).lower()
    for key, name in _SPECIAL_TYPES:
        if key in tid:
            return name
    base = str(box.get("base_type", "") or "")
    if base:
        return base
    for key, name in _BASE_TYPE_HINTS.items():
        if key in tid:
            return name
    return "car"


def vehicle_color(box: Dict) -> str:
    rgb = box.get("color_rgb")
    if rgb is not None and tuple(rgb) in _RGB_REMAP:
        return _RGB_REMAP[tuple(rgb)] + " "
    name = box.get("color_name")
    if name and name != "None":
        return str(name) + " "
    return ""


def box_distance(box: Dict) -> float:
    if "distance" in box:
        return float(box["distance"])
    p = np.asarray(box.get("position", [0.0, 0.0]), float)[:2]
    return float(np.hypot(p[0], p[1]))


def rough_position(box: Dict, with_distance: bool = True,
                   of_ego: bool = True) -> str:
    """'[far |nearby ]to the front[ left| right] of the ego vehicle'
    (reference :2143-2155; distance qualifier at >25 m / <15 m)."""
    far_or_close = ""
    if with_distance:
        d = box_distance(box)
        if d > 25:
            far_or_close = "far "
        elif d < 15:
            far_or_close = "nearby "
    y = float(np.asarray(box.get("position", [0, 0]), float)[1])
    if -2 <= y <= 2:
        side = "to the front"
    elif y > 2:
        side = "to the front right"
    else:
        side = "to the front left"
    suffix = " of the ego vehicle" if of_ego else " of it"
    return f"{far_or_close}{side}{suffix}"


# ---------------------------------------------------------------------------
# Projection + visibility (reference utils.py:131-230)
# ---------------------------------------------------------------------------

def project_corners(box: Dict) -> Optional[np.ndarray]:
    """All 8 bounding-box corners -> image pixels [8, 2] (None if the
    camera model rejects every corner). Corners sit on the ground plane
    and 2*extent_z above it, rotated by yaw, translated to position —
    the reference's project_all_corners layout (utils.py:131-183) using
    this repo's camera model (utils/geometry.py: FOV 110 at (-1.5,0,2))."""
    from simlingo_tpu_torch.utils.geometry import project_points

    pos = np.asarray(box.get("position", [0.0, 0.0, 0.0]), float)
    if pos.shape[0] == 2:
        pos = np.array([pos[0], pos[1], 0.0])
    ext = list(box.get("extent", [0.15, 0.15, 0.15]))
    while len(ext) < 3:
        ext.append(0.75)
    yaw = float(box.get("yaw", 0.0))
    ex, ey, ez = float(ext[0]), float(ext[1]), float(ext[2])
    corners = np.array([[sx * ex, sy * ey, z]
                        for z in (0.0, 2.0 * ez)
                        for sx in (-1, 1) for sy in (-1, 1)])
    rot = np.array([[np.cos(yaw), -np.sin(yaw), 0.0],
                    [np.sin(yaw), np.cos(yaw), 0.0],
                    [0.0, 0.0, 1.0]])
    corners = corners @ rot.T + pos
    pts = project_points(corners)
    if not np.isfinite(pts).any():
        return None
    return pts


def box_2d(pts: np.ndarray) -> List[List[float]]:
    """[[u_min, v_min], [u_max, v_max]] rounded to 0.1 px (reference
    generate_2d_box_from_projected_points :441-445)."""
    finite = pts[np.isfinite(pts).all(axis=1)]
    if finite.size == 0:
        finite = pts
    return [[round(float(finite[:, 0].min()), 1),
             round(float(finite[:, 1].min()), 1)],
            [round(float(finite[:, 0].max()), 1),
             round(float(finite[:, 1].max()), 1)]]


def visible_in_image(box: Dict) -> bool:
    pts = project_corners(box)
    if pts is None:
        return False
    ok = np.isfinite(pts).all(axis=1)
    pts = pts[ok]
    if pts.size == 0:
        return False
    inside = ((pts[:, 0] >= 0) & (pts[:, 0] < CAM_W)
              & (pts[:, 1] >= 0) & (pts[:, 1] < CAM_H))
    return bool(inside.any())


def should_consider_vehicle(box: Dict) -> bool:
    """Visibility gate (reference utils.py:208-230): skip parked
    non-cutting vehicles, actors behind the ego, and LiDAR-sparse boxes;
    require camera visibility."""
    if str(box.get("lane_type_str", "")) == "Parking" \
            and not box.get("vehicle_cuts_in"):
        return False
    pos = np.asarray(box.get("position", [0, 0]), float)
    if pos[0] < -1.5:
        return False
    n_pts = box.get("num_points")
    if n_pts is not None:
        role = str(box.get("role_name", ""))
        base = str(box.get("base_type", ""))
        if "scenario" in role:
            if n_pts < 10:
                return False
        elif base != "bicycle" and n_pts < 15:
            return False
    return visible_in_image(box)


# ---------------------------------------------------------------------------
# Scene container
# ---------------------------------------------------------------------------

@dataclass
class Scene:
    current: Dict
    ego: Dict                       # merged ego_info + measurement fields
    vehicles: List[Dict] = field(default_factory=list)
    vehicles_by_id: Dict = field(default_factory=dict)
    pedestrians: List[Dict] = field(default_factory=list)
    traffic_lights: List[Dict] = field(default_factory=list)
    stop_signs: List[Dict] = field(default_factory=list)
    static_objects: List[Dict] = field(default_factory=list)
    scenario: str = ""

    def ego_get(self, key, default=None):
        if key in self.ego:
            return self.ego[key]
        return self.current.get(key, default)


_VEHICLE_CLASSES = ("vehicle", "car", "static_car")


def classify_scene(current: Dict, boxes: Sequence[Dict]) -> Scene:
    """Split raw actor records into the categories the question builders
    consume (reference generate_perception_questions :2285-2313)."""
    ego: Dict = {}
    scene = Scene(current=current, ego=ego)
    for box in boxes:
        cls = str(box.get("class", box.get("type_id", ""))).split(".")[0]
        tid = str(box.get("type_id", "")).lower()
        if cls in ("ego_info", "ego_car"):
            ego.update({k: v for k, v in box.items() if k != "class"})
        elif cls in _VEHICLE_CLASSES or tid.startswith("vehicle"):
            scene.vehicles.append(box)
            if box.get("id") is not None:
                scene.vehicles_by_id[box["id"]] = box
        elif cls == "walker" or "pedestrian" in tid:
            scene.pedestrians.append(box)
        elif cls in ("traffic_light", "traffic_light_vqa"):
            scene.traffic_lights.append(box)
        elif cls == "stop_sign" or "stop" in tid:
            scene.stop_signs.append(box)
        elif cls in ("static", "static_trafficwarning") \
                or "trafficwarning" in tid or "constructioncone" in tid:
            scene.static_objects.append(box)
    scene.scenario = str(current.get("scenario",
                                     current.get("scenario_name", "")) or "")
    # is_in_junction: collector saves either name
    if "is_in_junction" not in ego:
        ego["is_in_junction"] = bool(
            current.get("is_in_junction", current.get("junction", False)))
    return scene


def ego_distance_to_junction(scene: Scene) -> float:
    d = scene.ego_get("distance_to_junction")
    return 1000.0 if d is None else float(d)


# ---------------------------------------------------------------------------
# Per-vehicle derived attributes with geometric fallbacks
# ---------------------------------------------------------------------------

def lane_relative_to_ego(box: Dict) -> int:
    """Signed lane offset (negative = left of ego). Falls back to
    y-offset / 3.5 m lane width when the collector didn't record it."""
    if box.get("lane_relative_to_ego") is not None:
        return int(box["lane_relative_to_ego"])
    y = float(np.asarray(box.get("position", [0, 0]), float)[1])
    return int(round(y / 3.5))


def same_direction_as_ego(box: Dict) -> bool:
    if box.get("same_direction_as_ego") is not None:
        return bool(box["same_direction_as_ego"])
    yaw = float(box.get("yaw", 0.0))
    return abs((yaw + np.pi) % (2 * np.pi) - np.pi) < np.pi / 2


def same_road_as_ego(box: Dict) -> bool:
    if box.get("same_road_as_ego") is not None:
        return bool(box["same_road_as_ego"])
    y = float(np.asarray(box.get("position", [0, 0]), float)[1])
    return abs(y) < 8.0


def points_towards_ego(box: Dict) -> bool:
    """Heading within 90° of the bearing back toward the ego (reference
    :2130-2141)."""
    pos = np.asarray(box.get("position", [0, 0]), float)[:2]
    angle_deg = (np.degrees(np.arctan2(pos[1], pos[0]))) % 360.0
    heading_deg = (np.degrees(float(box.get("yaw", 0.0)))) % 360.0
    return abs(heading_deg - angle_deg + 180.0) % 360.0 < 90.0


# ---------------------------------------------------------------------------
# Highway / acceleration-lane flags (reference :2078-2120 & :3085-3125)
# ---------------------------------------------------------------------------

HIGHWAY_SCENARIOS = (
    "EnterActorFlow", "EnterActorFlowV2", "HighwayCutIn", "HighwayExit",
    "MergerIntoSlowTraffic", "MergerIntoSlowTrafficV2",
    "YieldToEmergencyVehicle",
)


@dataclass
class HighwayFlags:
    is_highway: bool = False
    accel_lane: bool = False          # ego on the acceleration lane
    other_accel_lane: bool = False    # scenario actor on the accel lane
    exit_lane: bool = False
    entry_lane: bool = False
    about_to_exit: bool = False
    about_to_exit_far: bool = False


def highway_flags(scene: Scene) -> HighwayFlags:
    f = HighwayFlags()
    scenario = scene.scenario
    djunc = ego_distance_to_junction(scene)
    in_junc = bool(scene.ego_get("is_in_junction"))
    n_same = int(scene.ego_get("num_lanes_same_direction", 1) or 1)
    n_opp = int(scene.ego_get("num_lanes_opposite_direction", 0) or 0)
    lane_num = int(scene.ego_get("ego_lane_number", 0) or 0)
    command = int(scene.current.get("command", 4))
    speed_limit_kmh = int(float(scene.current.get("speed_limit", 0.0)) * 3.6)

    if scenario == "HighwayCutIn":
        f.is_highway = True
        if in_junc or djunc < 25:
            f.other_accel_lane = True
    elif scenario in ("HighwayExit", "MergerIntoSlowTrafficV2"):
        f.is_highway = True
        if in_junc or djunc < 25:
            f.exit_lane = True
        rightmost = (n_same - lane_num - 1 == 0)
        if (rightmost and command == 6 and djunc < 40) or in_junc or djunc < 10:
            f.about_to_exit = True
        if rightmost and command == 6:
            f.about_to_exit_far = True
    elif scenario in HIGHWAY_SCENARIOS and speed_limit_kmh > 50:
        f.is_highway = True
        if scenario == "MergerIntoSlowTraffic" and n_same == 1 and n_opp == 1:
            f.entry_lane = True
        elif scenario == "MergerIntoSlowTraffic" and n_same > 1:
            pass
        elif in_junc or djunc < 25:
            f.accel_lane = True
        elif n_same == 1 and n_opp == 0:
            f.entry_lane = True
    return f


# ---------------------------------------------------------------------------
# Key-object registry (reference generate_object_key_value :447-476)
# ---------------------------------------------------------------------------

def register_key_object(infos: Dict[str, Dict], category: str,
                        visual_description: str,
                        box: Optional[Dict] = None) -> str:
    """Add one object, keyed `<cN,CAM_FRONT[,u,v]>` where (u, v) is the
    2D-bbox center. Returns the tag."""
    n = len(infos) + 1
    entry = {"Category": category, "Status": None,
             "Visual_description": visual_description, "2d_bbox": None}
    tag = f"<c{n},CAM_FRONT>"
    if box is not None:
        pts = project_corners(box)
        if pts is not None:
            bb = box_2d(pts)
            entry["2d_bbox"] = bb
            cu = round((bb[0][0] + bb[1][0]) / 2.0, 1)
            cv = round((bb[0][1] + bb[1][1]) / 2.0, 1)
            entry["projected"] = [float(cu), float(cv)]
            tag = f"<c{n},CAM_FRONT,{cu},{cv}>"
        if box.get("id") is not None:
            entry["id"] = box["id"]
        entry["Status"] = ("moving"
                           if float(box.get("speed", 0.0)) > 0.2
                           else "stationary")
    infos[tag] = entry
    return tag


def tags_for_box(infos: Dict[str, Dict], box: Optional[Dict]) -> List[str]:
    """All tags whose 2d_bbox matches this box (reference
    get_key_of_key_object :693-701); falls back to actor-id match."""
    if box is None:
        return []
    pts = project_corners(box)
    if pts is not None:
        bb = box_2d(pts)
        keys = [k for k, v in infos.items() if v.get("2d_bbox") == bb]
        if keys:
            return keys
    if box.get("id") is not None:
        return [k for k, v in infos.items() if v.get("id") == box["id"]]
    return []

"""Graph-VQA label generation (DriveLM-CARLA style) at reference depth.

Copy of `simlingo_tpu/labels/vqa.py`.

Behavioral counterpart of reference
`dataset_generation/language_labels/drivelm/carla_vqa_generator.py`
(QAsGenerator, 3.2k LoC). The question inventory is split over four
modules:

  * `vqa_scene.py`   — scene assembly, naming, projection, visibility;
  * `vqa_vehicles.py`— per-vehicle chains, pedestrians, traffic elements;
  * `vqa_ego.py`     — braking / actor actions / obstruction lane changes;
  * `vqa_road.py`    — the seven road-layout questions;

plus, in this module, the merged important-objects question (reference
:2355-2420) and a set of flat scene-level extras kept from earlier rounds
(ego-state/navigation questions that widen the training distribution).

See docs/VQA_INVENTORY.md for the question-by-question diff against the
reference generator.
"""

from __future__ import annotations

import gzip
import json
import os
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from simlingo_tpu_torch.labels.vqa_ego import ego_questions
from simlingo_tpu_torch.labels.vqa_road import road_layout_questions
from simlingo_tpu_torch.labels.vqa_scene import (CAM_H, CAM_W, classify_scene,
                                           highway_flags, project_corners)
from simlingo_tpu_torch.labels.vqa_vehicles import (_entry, pedestrian_questions,
                                              stop_sign_questions,
                                              traffic_light_questions,
                                              vehicle_questions)

VEHICLE_NAMES = {
    "vehicle": "the vehicle", "walker": "the pedestrian",
    "traffic_light": "the traffic light", "stop_sign": "the stop sign",
}


def _object_description(box: Dict) -> str:
    kind = box.get("class", box.get("type_id", "object")).split(".")[0]
    color = box.get("color_name") or ""
    base = {"walker": "pedestrian"}.get(kind, kind.replace("_", " "))
    desc = f"{color} {base}".strip()
    pos = np.asarray(box.get("position", [0, 0, 0]))[:2]
    loc = _location_phrase(pos)
    return f"the {desc} {loc}"


def _location_phrase(pos: np.ndarray) -> str:
    x, y = float(pos[0]), float(pos[1])
    dist = "nearby" if np.hypot(x, y) < 15 else "far"
    if x > 2 and abs(y) < 2:
        side = "to the front of the ego vehicle"
    elif x > 2 and y < -2:
        side = "to the front left of the ego vehicle"
    elif x > 2 and y > 2:
        side = "to the front right of the ego vehicle"
    elif y < 0:
        side = "on the left side of the ego vehicle"
    else:
        side = "on the right side of the ego vehicle"
    return f"{dist} {side}"


# ---------------------------------------------------------------------------
# Flat scene-level extras (kept from earlier rounds; simple ego-state and
# navigation questions that are not part of the reference graph but widen
# the QA distribution the training mix samples from)
# ---------------------------------------------------------------------------

def q_important_objects(current: Dict, boxes: Sequence[Dict]) -> List[Dict]:
    objs = [b for b in boxes
            if b.get("class", "").split(".")[0] in ("vehicle", "walker")
            and np.asarray(b.get("position", [99, 99]))[0] > -2
            and np.linalg.norm(np.asarray(b.get("position", [99, 99]))[:2]) < 40]
    q = "What are the important objects in the scene?"
    if not objs:
        return [{"Q": q, "A": "There are no important objects in the scene."}]
    descs = sorted(_object_description(b) for b in objs[:4])
    return [{"Q": q, "A": "The important objects are " + ", ".join(descs) + "."}]


def q_traffic_light(current: Dict, boxes: Sequence[Dict]) -> List[Dict]:
    q = "Is the ego vehicle affected by a traffic light?"
    if current.get("light_hazard"):
        a = "Yes, the ego vehicle is affected by a red traffic light."
    else:
        a = "There is no traffic light affecting the ego vehicle."
    return [{"Q": q, "A": a}]


def q_stop_sign(current: Dict, boxes: Sequence[Dict]) -> List[Dict]:
    q = "Is the ego vehicle affected by a stop sign?"
    if current.get("stop_sign_hazard") or current.get("stop_sign_close"):
        a = "Yes, the ego vehicle is affected by a stop sign."
    else:
        a = "No, the ego vehicle is not affected by a stop sign."
    return [{"Q": q, "A": a}]


def q_junction(current: Dict, boxes: Sequence[Dict]) -> List[Dict]:
    q = "Is the ego vehicle at a junction?"
    if current.get("junction"):
        a = "Yes, the ego vehicle is at a junction."
    else:
        a = "There is no junction affecting the ego vehicle."
    return [{"Q": q, "A": a}]


def q_braking(current: Dict, boxes: Sequence[Dict]) -> List[Dict]:
    q = "What is the reason for the ego vehicle to brake?"
    if not (current.get("brake") or current.get("control_brake")):
        return [{"Q": q, "A": "There is no reason for the ego vehicle to brake."}]
    if current.get("light_hazard"):
        a = "The ego vehicle brakes because of the red traffic light."
    elif current.get("stop_sign_hazard"):
        a = "The ego vehicle brakes because of the stop sign."
    elif current.get("speed_reduced_by_obj_type"):
        kind = current["speed_reduced_by_obj_type"].split(".")[0]
        name = VEHICLE_NAMES.get(kind, "the object")
        d = current.get("speed_reduced_by_obj_distance")
        a = f"The ego vehicle brakes because of {name}" + (
            f" in {int(d)} m." if d is not None else ".")
    else:
        a = "The ego vehicle brakes to follow the target speed."
    return [{"Q": q, "A": a}]


def q_plan(current: Dict, boxes: Sequence[Dict]) -> List[Dict]:
    from simlingo_tpu_torch.data.measurements import COMMAND_MAP
    q = "What is the ego vehicle's planned action?"
    cmd = COMMAND_MAP.get(current.get("command", 4), "follow the road")
    ts = current.get("target_speed", 0.0)
    if ts < 0.5:
        a = "The ego vehicle plans to stop."
    else:
        a = f"The ego vehicle plans to {cmd} at roughly {ts:.0f} m/s."
    return [{"Q": q, "A": a}]


def q_object_motion(current: Dict, boxes: Sequence[Dict]) -> List[Dict]:
    out: List[Dict] = []
    for b in boxes[:4]:
        kind = b.get("class", "").split(".")[0]
        if kind not in ("vehicle", "walker"):
            continue
        desc = _object_description(b)
        q = f"What is the moving status of {desc}?"
        speed = float(b.get("speed", 0.0))
        if speed < 0.2:
            a = f"{desc.capitalize()} is not moving."
        else:
            yaw = float(b.get("yaw", 0.0))
            heading = ("in the same direction as the ego vehicle"
                       if abs(yaw) < 0.6 else
                       "towards the ego vehicle" if abs(yaw) > 2.5 else
                       "across the ego vehicle's path")
            a = f"{desc.capitalize()} is driving at {speed:.1f} m/s {heading}."
        out.append({"Q": q, "A": a})
    return out


def q_hazard_ahead(current: Dict, boxes: Sequence[Dict]) -> List[Dict]:
    q = "Is there a hazard the ego vehicle must react to?"
    if current.get("vehicle_hazard"):
        a = "Yes, a vehicle ahead requires the ego vehicle to react."
    elif current.get("walker_hazard"):
        a = "Yes, a pedestrian requires the ego vehicle to react."
    elif current.get("light_hazard"):
        a = "Yes, the ego vehicle must stop for the red traffic light."
    elif current.get("stop_sign_hazard"):
        a = "Yes, the ego vehicle must stop at the stop sign."
    else:
        a = "No, there is no hazard the ego vehicle must react to."
    return [{"Q": q, "A": a}]


def q_ego_action(current: Dict, boxes: Sequence[Dict]) -> List[Dict]:
    q = "What actions is the ego vehicle taking?"
    steer = float(current.get("steer", 0.0))
    if steer > 0.1:
        lat = "steering to the right"
    elif steer < -0.1:
        lat = "steering to the left"
    else:
        lat = "going straight"
    if current.get("brake"):
        lon = "braking"
    elif float(current.get("throttle", 0.0)) > 0.4:
        lon = "accelerating"
    else:
        lon = "keeping its speed"
    return [{"Q": q, "A": f"The ego vehicle is {lat} and {lon}."}]


def q_speed_state(current: Dict, boxes: Sequence[Dict]) -> List[Dict]:
    q = "What is the current speed of the ego vehicle?"
    v = float(current.get("speed", 0.0))
    if v < 0.2:
        a = "The ego vehicle is standing still."
    else:
        a = f"The ego vehicle is driving at about {v:.1f} m/s."
    return [{"Q": q, "A": a}]


def q_object_location(current: Dict, boxes: Sequence[Dict]) -> List[Dict]:
    out: List[Dict] = []
    for b in boxes[:4]:
        kind = b.get("class", "").split(".")[0]
        if kind not in ("vehicle", "walker"):
            continue
        color = b.get("color_name") or ""
        base = {"walker": "pedestrian"}.get(kind, kind.replace("_", " "))
        name = f"the {color} {base}".replace("  ", " ").strip()
        pos = np.asarray(b.get("position", [0, 0, 0]))[:2]
        dist = float(np.hypot(pos[0], pos[1]))
        out.append({"Q": f"Where is {name} relative to the ego vehicle?",
                    "A": f"{name.capitalize()} is "
                         f"{_location_phrase(pos)}, about {dist:.0f} m away."})
    return out


def q_navigation(current: Dict, boxes: Sequence[Dict]) -> List[Dict]:
    from simlingo_tpu_torch.data.measurements import COMMAND_MAP
    q = "What is the current navigation command?"
    cmd = COMMAND_MAP.get(current.get("command", 4), "follow the road")
    return [{"Q": q, "A": f"The navigation command is to {cmd}."}]


QUESTION_BUILDERS: Dict[str, Callable] = {
    "perception": q_important_objects,
    "perception_location": q_object_location,
    "perception_motion": q_object_motion,
    "navigation": q_navigation,
    "traffic_light": q_traffic_light,
    "stop_sign": q_stop_sign,
    "junction": q_junction,
    "prediction_hazard": q_hazard_ahead,
    "behaviour": q_ego_action,
    "behaviour_speed": q_speed_state,
    "planning_braking": q_braking,
    "planning_action": q_plan,
}


# ---------------------------------------------------------------------------
# Compatibility helpers used by tests and older callers
# ---------------------------------------------------------------------------

def project_box(box: Dict) -> Optional[np.ndarray]:
    """Visual-center pixel [u, v] or None if outside the front camera."""
    pts = project_corners(box)
    if pts is None:
        return None
    finite = pts[np.isfinite(pts).all(axis=1)]
    if finite.size == 0:
        return None
    uv = finite.mean(axis=0)
    if not (0 <= uv[0] < CAM_W and 0 <= uv[1] < CAM_H):
        inside = finite[(finite[:, 0] >= 0) & (finite[:, 0] < CAM_W)
                        & (finite[:, 1] >= 0) & (finite[:, 1] < CAM_H)]
        if inside.size == 0:
            return None
        uv = inside.mean(axis=0)
    return uv


def _crosses_ego_path(box: Dict) -> bool:
    """Does the actor's heading ray enter the ego corridor ahead?"""
    pos = np.asarray(box.get("position", [0, 0, 0]), float)[:2]
    yaw = float(box.get("yaw", 0.0))
    if abs(pos[1]) < 2.0 and pos[0] > 0:
        return True
    direction = np.array([np.cos(yaw), np.sin(yaw)])
    if abs(direction[1]) < 1e-3:
        return False
    t = -pos[1] / direction[1]
    if t <= 0 or t > 40.0:
        return False
    x_hit = pos[0] + t * direction[0]
    return 0.0 < x_hit < 40.0


def _link_chain(entries: List[Dict]) -> List[Dict]:
    """Sequential connection_up/down indices within one category list."""
    for i, e in enumerate(entries):
        if i > 0:
            e["connection_up"] = i - 1
        if i + 1 < len(entries):
            e["connection_down"] = i + 1
    return entries


# ---------------------------------------------------------------------------
# Important-objects merging (reference :2355-2420)
# ---------------------------------------------------------------------------

def important_objects_question(important_objects: List[str],
                               infos: Dict[str, Dict]) -> List[Dict]:
    question = "What are the important objects in the scene?"
    grouped: Dict[str, List[str]] = {}
    keep: List[str] = []
    for obj in important_objects:
        parts = obj.split(" to the ")
        head = parts[0][4:] if parts[0].startswith("the ") else parts[0]
        if len(parts) == 1:
            keep.append(obj)
        else:
            grouped.setdefault(" to the ".join(parts[1:]), []).append(head)

    merged: List[str] = list(keep)
    for suffix, heads in grouped.items():
        organize = []
        for head, count in Counter(heads).items():
            organize.append(f"the {count} {head}s" if count > 1
                            else f"the {head}")
        res = ""
        for i, piece in enumerate(organize):
            sep = ", "
            if i + 1 == len(organize) - 1:
                sep = " and "
            if i == len(organize) - 1:
                sep = ""
            res += f"{piece}{sep}"
        merged.append(f"{res} to the {suffix}")

    concat = ""
    for i, obj in enumerate(merged):
        sep = ","
        if i + 1 == len(merged) - 1:
            sep = " and"
        if i == len(merged) - 1:
            sep = ""
        concat += f" {obj}{sep}"

    if not merged:
        answer = "There are no important objects in the scene."
    elif len(important_objects) == 1:
        answer = f"The important object in the scene is{concat}."
    else:
        answer = f"The important objects in the scene are{concat}."
    return [_entry(question, answer, 0, 0, "perception",
                   list(infos.keys()))]


# ---------------------------------------------------------------------------
# Graph assembly
# ---------------------------------------------------------------------------

def build_graph_qa(current: Dict, boxes: Sequence[Dict]
                   ) -> Dict[str, List[Dict]]:
    """The DriveLM categories at reference depth: important_objects,
    dynamic_vehicles, roadlayout, stopsign, trafficlight, pedestrian, ego
    (reference generate_perception_questions :2255-2433)."""
    scene = classify_scene(current, boxes)
    flags = highway_flags(scene)
    important_objects: List[str] = []
    infos: Dict[str, Dict] = {}

    cats: Dict[str, List[Dict]] = {}
    cats["dynamic_vehicles"] = vehicle_questions(scene, flags,
                                                 important_objects, infos)
    cats["roadlayout"] = road_layout_questions(scene, flags,
                                               important_objects, infos)
    stopsign, ss_info, ss_tags = stop_sign_questions(scene,
                                                     important_objects, infos)
    cats["stopsign"] = stopsign
    trafficlight, tl_info, tl_tags = traffic_light_questions(
        scene, important_objects, infos)
    cats["trafficlight"] = trafficlight
    cats["pedestrian"] = pedestrian_questions(scene, important_objects,
                                              infos)
    cats["ego"] = ego_questions(scene, flags, important_objects, infos,
                                tl_info, ss_info, tl_tags, ss_tags)
    cats["important_objects"] = important_objects_question(
        important_objects, infos)
    for cat in cats:
        _link_chain(cats[cat])
    cats["_key_object_infos"] = infos  # carried to generate_vqa
    return cats


def generate_vqa(current: Dict, boxes: Optional[Sequence[Dict]] = None
                 ) -> Dict:
    """One frame -> drivelm-format record {'QA': {cat: [...]},
    'key_object_infos': {tag: info}}.

    QA holds the reference graph categories (build_graph_qa) plus the flat
    scene-level extras; key_object_infos is tag-keyed as in DriveLM.
    """
    boxes = boxes or []
    qa = {cat: fn(current, boxes) for cat, fn in QUESTION_BUILDERS.items()}
    graph = build_graph_qa(current, boxes)
    infos = graph.pop("_key_object_infos")
    qa.update(graph)
    return {"QA": qa, "key_object_infos": infos}


def generate_route_vqa(route_dir: str, out_root: Optional[str] = None) -> int:
    """Write vqa/NNNN.json.gz per frame (layout of dataset_driving.py:121)."""
    from simlingo_tpu_torch.data.measurements import read_json_gz

    mdir = os.path.join(route_dir, "measurements")
    out_dir = (os.path.join(route_dir, "vqa") if out_root is None
               else os.path.join(out_root, os.path.basename(route_dir), "vqa"))
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for fn in sorted(os.listdir(mdir)):
        if not fn.endswith(".json.gz"):
            continue
        current = read_json_gz(os.path.join(mdir, fn))
        boxes_path = os.path.join(route_dir, "boxes", fn)
        boxes = read_json_gz(boxes_path) if os.path.isfile(boxes_path) else []
        with gzip.open(os.path.join(out_dir, fn), "wt") as f:
            json.dump(generate_vqa(current, boxes), f)
        n += 1
    return n

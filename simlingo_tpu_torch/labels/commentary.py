"""Rule-based driving commentary generation.

Copy of `simlingo_tpu/labels/commentary.py`.

Behavioral counterpart of reference
`dataset_generation/language_labels/commentary/carla_commentary_generator.py`
(COMsGenerator.generate_commentary :449-947): per-frame natural-language
commentary assembled from

  * a route action (follow / turn / lane change / scenario-specific route
    management incl. TwoWays-oncoming, InvadingTurn shift, wait-for-gap,
    return-to-lane),
  * a speed action (remain stopped / stop / maintain (reduced) / accelerate /
    decelerate -- decided against the MEAN of the next 5 future target
    speeds, reference :662-697),
  * a reason clause naming the cause object (leader vehicle at/slowing for a
    red light, stationary leader, crossing bicycle/walker, stop sign
    clearance, collision prevention, junction cross-traffic reasoning),
  * a trailing walker-attention warning.

The cause object is exported with its appearance string + camera visibility
so downstream augmentation can splice referring expressions (reference
returns (commentary, cause_visible, cause_object, appearance)).

Built-in default templates cover every phrase key; a template json
(data/augmented_templates/commentary.json layout) extends them.
"""

from __future__ import annotations

import gzip
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_TEMPLATES: Dict[str, List[str]] = {
    "remain_stopped": ["The ego vehicle remains stopped"],
    "stop_now": ["The ego vehicle stops"],
    "maintain_speed": ["The ego vehicle maintains its speed"],
    "maintain_reduced_speed": ["The ego vehicle maintains a reduced speed"],
    "accelerate": ["The ego vehicle accelerates"],
    "decelerate": ["The ego vehicle slows down"],
    "stay_behind": ["Stay behind"],
    "drive_closer": ["Drive closer to"],
    "prevent_collision": ["Prevent a collision with"],
    "cleared_stop": ["The stop sign was cleared"],
    "cross_path": ["That is crossing the ego vehicle's path"],
    "wait_gap": ["The ego vehicle waits for a gap in the traffic"],
    "gap_big": ["the gap to the next vehicle is big enough"],
    "go_back": ["Return to the original lane."],
    "shift_right": ["Shift slightly to the right side of the lane"],
    # scenario route actions (reference templates keyed by scenario base name)
    "ConstructionObstacle": ["Change lanes to bypass the construction site."],
    "Accident": ["Change lanes to bypass the accident."],
    "ParkedObstacle": ["Change lanes to bypass the parked vehicle."],
    "VehicleOpensDoor": ["Change lanes to bypass the open car door."],
    "HazardAtSideLane": ["Move slightly to the left to bypass the bicycles."],
    "ParkingExit": ["Exit the parking lot."],
}

_OBJ_APPEARANCE = {
    "traffic.stop": "stop sign",
    "traffic_light": "red traffic light",
    "trafficwarning": "construction site",
}


def vehicle_appearance(box: Optional[Dict]) -> str:
    """Referring expression for a cause box (reference
    language_labels/utils.py:get_vehicle_appearance_string)."""
    if box is None:
        return "vehicle"
    kind = box.get("class", box.get("type_id", "vehicle")).split(".")[0]
    base = {"walker": "pedestrian", "car": "vehicle"}.get(kind, kind)
    if box.get("base_type") == "bicycle":
        base = "bicycle"
    color = box.get("color_name") or ""
    return f"{color} {base}".strip()


def _visible(box: Optional[Dict]) -> bool:
    """Camera-visibility gate (reference is_vehicle_visible_in_image +
    num_points/position filters, :707-710)."""
    if box is None:
        return False
    if box.get("num_points", 99) <= 3:
        return False
    pos = box.get("position")
    if pos is not None and pos[0] <= -1.5:
        return False
    try:
        from simlingo_tpu_torch.labels.vqa import project_box
        return project_box(box) is not None
    except Exception:
        return True


class CommentaryGenerator:
    def __init__(self, templates: Optional[Dict[str, List[str]]] = None,
                 augment: bool = False, seed: int = 0):
        self.templates = dict(DEFAULT_TEMPLATES)
        if templates:
            self.templates.update(templates)
        self.augment = augment
        self.rng = np.random.RandomState(seed)
        self.all_templates: List[str] = []

    def _pick(self, key: str) -> str:
        cand = self.templates.get(key, DEFAULT_TEMPLATES.get(key, [key]))
        if self.augment:
            return cand[self.rng.randint(len(cand))]
        return cand[0]

    def _lower(self, s: str) -> str:
        return s[0].lower() + s[1:] if s else s

    # -- junction cross-traffic reasoning (reference :700-736) --------------
    def _junction_reason(self, current: Dict, boxes: Sequence[Dict]
                         ) -> Tuple[Optional[str], Optional[bool]]:
        d_junc = current.get("distance_to_junction")
        in_j = current.get("is_in_junction", False)
        if not in_j and (d_junc is None or d_junc >= 15):
            return None, None
        stopped = None
        other_in_junction = False
        for b in boxes:
            if b.get("class") not in ("car", "vehicle"):
                continue
            if not _visible(b):
                continue
            if b.get("is_in_junction"):
                other_in_junction = True
            if not b.get("pointing_towards_junction", False):
                continue
            slow = b.get("brake", 0.0) > 0.8 or b.get("speed", 99) < 1.0
            if b.get("distance", 0.0) > b.get("speed", 0.0) * 7 and not slow:
                continue
            stopped = bool(slow)
        if stopped is None:
            return "", None
        if stopped:
            if other_in_junction:
                return ("the other vehicles are stopped at the junction and "
                        "the vehicle in the junction is moving away"), True
            return ("the other vehicles are stopped at the junction and the "
                    "junction is clear"), True
        if other_in_junction:
            return "pay attention to the vehicle in the junction", False
        return "pay attention to the vehicles coming towards the junction", False

    # -- route-change geometry (reference :526-556) --------------------------
    @staticmethod
    def _route_change_state(current: Dict) -> Dict[str, bool]:
        route = np.asarray(current.get("route", []), float)
        orig = np.asarray(current.get("route_original", []), float)
        n = min(len(route), len(orig))
        out = {"on_adjusted": False, "future_changed": False,
               "future_changed_far": False, "future_org": False}
        if n == 0:
            return out
        out["on_adjusted"] = bool(np.linalg.norm(orig[0]) > 2.5)
        changed_flag = bool(current.get("changed_route", False))
        for i in range(min(10, n)):
            d = float(np.linalg.norm(route[i] - orig[i]))
            if d < 0.6 and changed_flag:
                out["future_org"] = True
            if d > 0.6:
                out["future_changed"] = True
        for i in range(min(20, n)):
            if float(np.linalg.norm(route[i] - orig[i])) > 0.6:
                out["future_changed_far"] = True
        return out

    def generate(self, current: Dict,
                 future: Optional[Sequence[Dict]] = None,
                 boxes: Sequence[Dict] = (),
                 scenario_name: Optional[str] = None) -> Dict:
        """One frame's measurement dict (+ GT boxes) -> commentary record
        {'commentary', 'commentary_template', 'placeholder',
         'cause_object', 'cause_object_visible'}."""
        speed = current.get("speed", 0.0)
        target_speed = current.get("target_speed", 0.0)
        speed_limit = current.get("speed_limit") or 30.0
        scenario = scenario_name or current.get("scenario_name") or ""
        boxes_by_id = {int(b["id"]): b for b in boxes if "id" in b}

        # ---- speed action vs mean future target speed (reference :662-697)
        if future:
            avg_future = float(np.mean(
                [m.get("target_speed", target_speed) for m in future[:5]]))
        else:
            avg_future = target_speed
        accelerate = decelerate = maintain = stopped_ego = False
        if speed < 0.2 and abs(speed - avg_future) < 0.5:
            action_speed = self._pick("remain_stopped")
            stopped_ego = True
        elif abs(speed - avg_future) < 0.5:
            if avg_future < 0.2:
                action_speed = self._pick("stop_now")
            elif avg_future / speed_limit > 0.71:
                action_speed = self._pick("maintain_speed")
                maintain = True
            else:
                action_speed = self._pick("maintain_reduced_speed")
                maintain = True
        elif speed < avg_future:
            action_speed = self._pick("accelerate")
            accelerate = True
        else:
            action_speed = self._pick("decelerate")
            decelerate = True

        # ---- cause object resolution (reference :576-646) ----
        obj_type = current.get("speed_reduced_by_obj_type")
        obj_id = current.get("speed_reduced_by_obj_id")
        obj_dist = current.get("speed_reduced_by_obj_distance")
        cause_box = boxes_by_id.get(obj_id) if obj_id is not None else None
        d_junc = current.get("distance_to_junction")
        if current.get("stop_sign_hazard"):
            obj_type, cause_box = "traffic.stop", None
            obj_dist = (d_junc - 5) if d_junc is not None else None
        elif current.get("light_hazard") and (d_junc is not None
                                              and d_junc < 40):
            obj_type, cause_box = "traffic_light", None
            obj_dist = d_junc - 5
        # manual red-light check (reference :637-651)
        cause_at_light = False
        if cause_box is None:
            for b in boxes:
                if b.get("class") == "traffic_light" \
                        and b.get("affects_ego") and b.get("state") == "Red" \
                        and b.get("distance", 99) < 40:
                    obj_type, cause_box = "traffic_light", b
                    obj_dist = b.get("distance")
                    break
        if cause_box is not None \
                and cause_box.get("traffic_light_state") == "Red":
            cause_at_light = True
        if obj_dist is not None and obj_dist > 40:
            obj_type = obj_dist = cause_box = None

        if cause_box is not None:
            appearance = vehicle_appearance(cause_box)
        elif obj_type:
            key = next((k for k in _OBJ_APPEARANCE if k in obj_type), None)
            appearance = _OBJ_APPEARANCE.get(key) or (
                "vehicle" if "vehicle" in obj_type
                else "walker" if "walker" in obj_type else obj_type)
        else:
            appearance = ""
        cause_visible = _visible(cause_box) if cause_box is not None else True
        if obj_dist is not None:
            obj_dist = round(float(obj_dist), 1)

        junction_reason, junction_stopped = self._junction_reason(
            current, boxes)

        # walker filters (reference :503-521)
        walkers = [b for b in boxes if b.get("class") == "walker"]
        walker_hazard = bool(current.get("walker_hazard")) and (
            not walkers or any(w.get("num_points", 99) > 3 for w in walkers))
        walker_attention = any(
            w.get("distance", 99) < 15 and w.get("speed", 0) > 0.5
            and w.get("num_points", 99) > 3 for w in walkers)

        vehicle_hazard = current.get("vehicle_hazard", False)
        hazard_box = boxes_by_id.get(current.get("vehicle_affecting_id"))

        # ---- reason clause (reference :737-866) ----
        reason = "."
        if obj_type == "traffic.stop" and speed < target_speed \
                and target_speed > 0.4 and abs(speed - target_speed) > 0.5 \
                and obj_dist is not None and obj_dist < 5:
            cleared = self._lower(self._pick("cleared_stop"))
            if junction_reason in (None, ""):
                reason = f" since {cleared}."
            elif junction_stopped:
                reason = f" since {cleared} and {junction_reason}."
            else:
                reason = f" since {cleared} but {junction_reason}."
        elif vehicle_hazard and hazard_box is not None and (
                cause_box is None or hazard_box.get("distance", 0)
                <= cause_box.get("distance", 99) - 5):
            appearance = vehicle_appearance(hazard_box)
            cause_box, cause_visible = hazard_box, _visible(hazard_box)
            reason = (f" to {self._lower(self._pick('prevent_collision'))} "
                      f"the {appearance}.")
        elif walker_hazard:
            if d_junc is not None and obj_dist is not None \
                    and obj_dist > d_junc + 5 and accelerate:
                reason = (f" to drive through the junction as "
                          f"{junction_reason}. Pay attention to the "
                          f"pedestrian on the exit of the junction.")
            else:
                reason = (f" due to the {appearance or 'pedestrian'} "
                          f"{self._lower(self._pick('cross_path'))}.")
        elif obj_type is not None and "vehicle" in str(obj_type) \
                or (cause_box is not None
                    and cause_box.get("class") in ("car", "vehicle")):
            stay = self._lower(self._pick("stay_behind"))
            closer = self._lower(self._pick("drive_closer"))
            if cause_box is not None \
                    and cause_box.get("base_type") == "bicycle" \
                    and cause_box.get("role_name") == "scenario" \
                    and "HazardAtSideLane" not in scenario:
                reason = (f" to avoid the {appearance} that is crossing "
                          f"the road.")
            elif cause_at_light and speed < 0.2 and not accelerate:
                reason = (f" to {stay} the {appearance} that is stopped "
                          f"because of a red traffic light.")
            elif cause_at_light and not accelerate:
                reason = (f" to {stay} the {appearance} that is slowing "
                          f"down because of a red traffic light.")
            elif not decelerate and target_speed > 0.5 \
                    and cause_box is not None \
                    and cause_box.get("distance", 99) < 12 \
                    and cause_box.get("speed", 99) < 0.5:
                reason = f" to {closer} the stationary {appearance}."
            elif accelerate:
                reason = (f" to follow the {appearance}"
                          + (f" in {obj_dist} meters." if obj_dist is not None
                             else "."))
            else:
                reason = (f" to {stay} the {appearance}"
                          + (f" in {obj_dist} meters." if obj_dist is not None
                             else "."))
        elif obj_type is not None:
            closer = self._lower(self._pick("drive_closer"))
            if accelerate:
                if obj_dist is not None and 5 < obj_dist < 15:
                    reason = f" to {closer} the {appearance} in {obj_dist} meters."
                elif obj_dist is None:
                    reason = f" to {closer} the {appearance}."
                else:
                    reason = " to reach the speed limit."
            else:
                if obj_dist is None:
                    reason = f" due to the {appearance}."
                elif obj_dist < 20:
                    reason = f" due to the {appearance} in {obj_dist} meters."
                else:
                    reason = " to drive according to the speed limit."
        else:
            light = next((b for b in boxes if b.get("class") == "traffic_light"
                          and b.get("affects_ego")), None)
            if light is not None and light.get("state") == "Green":
                reason = " because the traffic light is green"
                if junction_reason:
                    if junction_stopped:
                        reason += f" and {junction_reason}."
                    else:
                        reason += (" but pay attention to the vehicle "
                                   "coming towards the junction.")
                else:
                    reason += "."
            else:
                if current.get("is_in_junction"):
                    reason = ("" if (decelerate or stopped_ego)
                              else " to drive through the junction")
                else:
                    reason = "" if maintain else " to drive with the target speed"
                if junction_reason and junction_stopped:
                    reason += f" because {junction_reason}."
                else:
                    reason += "."

        # ---- route action (reference :556-575, :868-940) ----
        cmd = current.get("command", 4)
        tp = current.get("target_point", (99.0, 99.0))
        d_tp = float(np.hypot(tp[0], tp[1]))
        action_route = "Follow the route."
        y_closest = abs(current.get("route", [[0, 0]])[0][1])
        if scenario == "ParkingExit" and y_closest > 1.5:
            action_route = self._pick("ParkingExit")
        elif cmd in (5, 6):
            if d_tp < 10:
                action_route = "Do a lane change."
            elif d_tp < 20:
                action_route = "Prepare to do a lane change."
        elif cmd == 1 and d_tp < 20:
            action_route = "Turn left."
        elif cmd == 2 and d_tp < 20:
            action_route = "Turn right."

        rc = self._route_change_state(current)
        changed = current.get("changed_route", False) or rc["future_changed"]
        if changed or rc["future_changed_far"]:
            base = scenario.replace("TwoWays", "")
            oncoming = "TwoWays" in scenario
            if base in self.templates:
                if rc["future_changed"] or changed:
                    action_route = self._pick(base)
                elif rc["future_changed_far"]:
                    action_route = "Prepare to " + self._lower(self._pick(base))
            if changed:
                lane_info = ("oncoming lane" if oncoming
                             else "neighbouring lane")
                mean_x = 1.0
                if future:
                    try:
                        from simlingo_tpu_torch.utils.geometry import \
                            inverse_conversion_2d
                        cur_pos = np.asarray(current["pos_global"], float)
                        pts = [inverse_conversion_2d(
                            np.asarray(m["pos_global"], float), cur_pos,
                            current.get("theta", 0.0)) for m in future[1:-1]]
                        if pts:
                            mean_x = float(np.mean([p[0] for p in pts]))
                    except Exception:
                        pass
                if "InvadingTurn" in scenario:
                    action_route = (self._pick("shift_right")
                                    + " to make space for the traffic that "
                                      "invades the lane because of the "
                                      "traffic cones.")
                elif (mean_x < 0.5 or target_speed < 0.2) \
                        and (not rc["on_adjusted"]) and rc["future_changed"]:
                    action_speed = self._pick("wait_gap") + (
                        " to the lane with oncoming traffic" if oncoming
                        else "")
                    reason = ""
                elif not rc["on_adjusted"] and not rc["future_org"]:
                    reason = (f" to change to the {lane_info}, "
                              f"{self._pick('gap_big')}")
                elif rc["future_org"]:
                    action_route = self._pick("go_back")
                else:
                    lane = ("your current (oncoming) lane" if oncoming
                            else "your current lane")
                    action_route = (f"Stay on {lane} to "
                                    f"{self._lower(action_route)}")

        post = ""
        if walker_attention and (obj_type is None
                                 or "walker" not in str(obj_type)):
            post = " Pay attention to the walker and brake if necessary."

        commentary = f"{action_route} {action_speed}{reason}{post}."
        commentary = commentary.replace("...", ".").replace("..", ".") \
                               .replace("  ", " ")

        # ---- placeholder template for paraphrase augmentation ----
        template = commentary
        placeholder: Dict[str, str] = {}
        if appearance:
            m = re.search(
                rf"the (?:stationary )?{re.escape(appearance)}"
                rf"(?: in [\d.]+ meters)?", commentary)
            if m and cause_box is not None:
                template = commentary.replace(m.group(0), "<OBJECT>")
                placeholder["<OBJECT>"] = m.group(0)
        template = re.sub(r"in -?\d+\.?\d* meters", "in <DISTANCE>", template)
        if template not in self.all_templates:
            self.all_templates.append(template)
        return {"commentary": commentary, "commentary_template": template,
                "placeholder": placeholder,
                "cause_object": cause_box,
                "cause_object_visible": bool(cause_visible),
                "cause_object_appearance": appearance}


def generate_route_commentary(route_dir: str, out_root: Optional[str] = None,
                              augment: bool = False) -> int:
    """Write commentary/NNNN.json.gz for every measurement in a route
    (the directory layout the training pipeline reads,
    dataset_driving.py:86). Reads GT boxes when the collector saved them."""
    from simlingo_tpu_torch.data.measurements import read_json_gz

    gen = CommentaryGenerator(augment=augment)
    mdir = os.path.join(route_dir, "measurements")
    bdir = os.path.join(route_dir, "boxes")
    if out_root is None:
        out_dir = os.path.join(route_dir, "commentary")
    else:
        out_dir = os.path.join(out_root, os.path.basename(route_dir),
                               "commentary")
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(mdir) if f.endswith(".json.gz"))
    measurements = [read_json_gz(os.path.join(mdir, f)) for f in files]
    n = 0
    for i, fn in enumerate(files):
        boxes: Sequence[Dict] = ()
        bpath = os.path.join(bdir, fn)
        if os.path.isfile(bpath):
            boxes = read_json_gz(bpath)
        rec = gen.generate(measurements[i], future=measurements[i + 1:i + 6],
                           boxes=boxes)
        with gzip.open(os.path.join(out_dir, fn), "wt") as f:
            json.dump(rec, f)
        n += 1
    return n

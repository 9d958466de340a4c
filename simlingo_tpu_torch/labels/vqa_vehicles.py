"""Per-vehicle, pedestrian, and traffic-element question chains.

Copy of `simlingo_tpu/labels/vqa_vehicles.py`.

Behavioral counterpart of reference `carla_vqa_generator.py`:
  * generate_vehicle_information (:1516-2253) — four chained questions per
    camera-visible vehicle (position on road, trajectory, motion status,
    path crossing), with junction/highway/lane-relative conditioning;
  * process_pedestrians (:500-563);
  * process_stop_signs (:565-616) / process_traffic_lights (:618-691).

Entries use the repo's QA-record shape {"Q", "A", chain, layer, qa_type,
object_tags}; connection_up/down links are filled per-category by
`vqa._link_chain`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simlingo_tpu_torch.labels.vqa_scene import (HighwayFlags, Scene, box_distance,
                                           ego_distance_to_junction,
                                           lane_relative_to_ego,
                                           number_to_word, points_towards_ego,
                                           register_key_object, rough_position,
                                           same_direction_as_ego,
                                           same_road_as_ego,
                                           should_consider_vehicle,
                                           vehicle_color, vehicle_type_name)


def _entry(question: str, answer: str, chain: int, layer: int, qa_type: str,
           tags: Sequence[str]) -> Dict:
    return {"Q": question, "A": answer, "chain": chain, "layer": layer,
            "qa_type": qa_type, "connection_up": -1, "connection_down": -1,
            "object_tags": list(tags)}


# ---------------------------------------------------------------------------
# Command phrasing shared by path crossing (reference :1571-1599)
# ---------------------------------------------------------------------------

def crossing_command(current: Dict, ego_in_junction: bool,
                     dist_to_junction: float) -> Tuple[int, str]:
    """The reference re-derives the effective command: distant target
    points demote lane changes to follow-the-road, and lane-change
    commands with a straight target point become straight/follow."""
    command_int = int(current.get("command", 4))
    tp = np.asarray(current.get("target_point", [20.0, 0.0]), float)
    command_distance = float(np.hypot(tp[0], tp[1]))
    if command_distance > 25:
        command_int = 4
    if command_int in (5, 6) and abs(tp[1]) < 1.0:
        command_int = 3 if dist_to_junction < 40 else 4
    command_map = {
        1: "turns left at the next intersection",
        2: "turns right at the next intersection",
        3: "drives straight at the next intersection",
        4: "follows the road",
        5: f"does a lane change to the left in {int(command_distance)} m",
        6: f"does a lane change to the right in {int(command_distance)} m",
    }
    command_str = command_map[command_int]
    if ego_in_junction:
        command_str = (command_str
                       .replace("turns", "continues turning")
                       .replace("drives", "continues driving")
                       .replace("next intersection", "current intersection"))
    return command_int, command_str


# ---------------------------------------------------------------------------
# Question 1: Where on the road is the vehicle located? (:1820-2043)
# ---------------------------------------------------------------------------

def q_vehicle_position(scene: Scene, flags: HighwayFlags, box: Dict,
                       loc_desc: str, desc: str,
                       tags: Sequence[str]) -> Tuple[Dict, Optional[bool]]:
    ego = scene
    question = f"Where on the road is {loc_desc} located?"
    pos = np.asarray(box.get("position", [0, 0]), float)
    same_road = same_road_as_ego(box)
    same_dir = same_direction_as_ego(box)
    in_junction = bool(box.get("is_in_junction", False))
    pointing_towards_junction: Optional[bool] = None

    deg = np.degrees(float(box.get("yaw", 0.0)))
    if -135 < deg < -45:
        orientation = "is pointing leftwards"
    elif 45 < deg < 135:
        orientation = "is pointing rightwards"
    elif deg > 135 or deg < -135:
        orientation = "is pointing towards the ego vehicle"
    else:
        orientation = "is pointing in the same direction as the ego vehicle"

    ego_junc = ego.ego_get("junction_id", -1)
    ego_next_junc = ego.ego_get("next_junction_id", -1)
    veh_junc = box.get("junction_id", -1)
    next_road_ids = list(ego.ego_get("next_road_ids", []) or [])
    next_next_road_ids = list(ego.ego_get("next_next_road_ids_ego", []) or [])
    lane_rel = lane_relative_to_ego(box)
    answer = ""

    if in_junction and (veh_junc == ego_next_junc or veh_junc == ego_junc
                        or (ego_junc == -1 and ego_next_junc == -1)):
        if flags.is_highway and (flags.accel_lane or flags.exit_lane):
            lane_str = "merging area" if flags.accel_lane else "exit area"
            if same_road and same_dir and lane_rel == 0:
                answer = (f"The {desc} is in the {lane_str} of the highway "
                          "in front of the ego vehicle.")
            elif box.get("lane_id") == -1:
                answer = (f"The {desc} is close to the {lane_str} but on the "
                          "leftmost lane of the highway.")
            elif box.get("lane_id") == -2:
                answer = (f"The {desc} is close to the {lane_str} but on the "
                          "second lane from the left on the highway.")
            else:
                answer = f"The {desc} is on the highway near the {lane_str}."
        elif flags.entry_lane:
            answer = f"The {desc} is on the lane that leads to the highway."
        elif flags.about_to_exit:
            answer = f"The {desc} is on the exit lane of the highway."
        elif flags.is_highway:
            answer = f"The {desc} is on the highway."
        else:
            answer = (f"The {desc} is inside the upcoming junction "
                      f"and {orientation}.")
        if scene.scenario == "MergerIntoSlowTrafficV2":
            n_same = int(ego.ego_get("num_lanes_same_direction", 1) or 1)
            lane_num = int(ego.ego_get("ego_lane_number", 0) or 0)
            djunc = ego_distance_to_junction(scene)
            road_id = box.get("road_id")
            near_exit_roads = (road_id in next_road_ids
                               or road_id == ego.ego_get("road_id")
                               or road_id in next_next_road_ids)
            if (n_same == 1 and same_road) or (
                    n_same - lane_num - 1 == 0 and djunc < 25
                    and near_exit_roads):
                answer = f"The {desc} is on the exit lane of the highway."
            elif (n_same == 1 and not same_road) or (
                    n_same > 1 and (bool(ego.ego_get("is_in_junction"))
                                    or djunc < 25)):
                answer = f"The {desc} is on the highway near the exit area."
            else:
                answer = (f"The {desc} is on the highway close to the "
                          "merging area.")

    elif not in_junction and not same_road \
            and box.get("road_id") not in next_road_ids:
        # other road: relate it to the junction
        veh_next_junc = box.get("next_junction_id", -1)
        if ego_junc == -1 or veh_junc == -1:
            if pos[1] < -8 and 45 < deg < 135:
                to_or_away, pointing_towards_junction = \
                    "is pointing towards the junction", True
            elif pos[1] > 8 and -135 < deg < -45:
                to_or_away, pointing_towards_junction = \
                    "is pointing towards the junction", True
            elif pos[1] < -8 and -135 < deg < -45:
                to_or_away, pointing_towards_junction = \
                    "is pointing away from the junction", False
            elif pos[1] > 8 and 45 < deg < 135:
                to_or_away, pointing_towards_junction = \
                    "is pointing away from the junction", False
            elif -8 < pos[1] < 8 and (deg > 135 or deg < -135):
                to_or_away, pointing_towards_junction = \
                    "is pointing towards the junction", True
            elif -8 < pos[1] < 8 and -45 < deg < 45:
                to_or_away, pointing_towards_junction = \
                    "is pointing away from the junction", False
            else:
                to_or_away, pointing_towards_junction = \
                    "is pointing in an unknown direction", False
        elif veh_next_junc in (ego_next_junc, ego_junc):
            to_or_away, pointing_towards_junction = \
                "is pointing towards the junction", True
        else:
            to_or_away, pointing_towards_junction = \
                "is pointing away from the junction", False

        if pos[1] < -8:
            direction_junction = "on the left side of the junction"
        elif pos[1] > 8:
            direction_junction = "on the right side of the junction"
        else:
            direction_junction = "on the opposite side of the junction"
        bike_lane_str = (" on the bike lane"
                         if box.get("lane_type_str") == "Biking" else "")
        answer = (f"The {desc} is {direction_junction}{bike_lane_str} "
                  f"and {to_or_away}.")
        if flags.is_highway:
            lane_id = box.get("lane_id")
            ordinal = {-1: "leftmost lane", -2: "second lane from the left",
                       -3: "third lane from the left",
                       -4: "fourth lane from the left"}.get(lane_id)
            if ordinal:
                answer = (f"The {desc} is driving on the {ordinal} "
                          "on the highway.")
            else:
                answer = f"The {desc} is driving on the highway."

    elif bool(ego.ego_get("is_in_junction")) \
            and box.get("road_id") in next_road_ids:
        if flags.is_highway:
            answer = f"The {desc} is on the highway."
        else:
            answer = (f"The {desc} is after the junction on the road the "
                      f"ego vehicle will enter. It {orientation}.")

    elif not in_junction and same_road:
        val = int(lane_rel)
        moving = "standing" if float(box.get("speed", 0.0)) < 0.5 \
            else "driving"
        bike_lane_str = (" on the bike lane"
                         if box.get("lane_type_str") == "Biking" else "")
        if val == 0:
            answer = (f"The {desc} is on the same road {moving} on the "
                      "lane of the ego vehicle.")
        else:
            s = "s" if abs(val) > 1 else ""
            side = "right" if val > 0 else "left"
            rel = f"{number_to_word(abs(val))} lane{s} to the {side} of"
            direction = "same" if same_dir else "opposite"
            answer = (f"The {desc} is on the same road {moving} in the "
                      f"{direction} direction. It is{bike_lane_str} {rel} "
                      "the ego vehicle.")
        if same_dir and val == 0:
            pass
        elif not same_dir and val == 0:
            answer = (f"The {desc} is on the same road {moving} in the "
                      "opposite direction.")
        if flags.entry_lane:
            answer = (f"The {desc} is in the same lane leading to the "
                      "highway as the ego vehicle.")
    else:
        answer = (f"The {desc} is "
                  f"{rough_position(box)}.")

    if "scenario" in str(box.get("role_name", "")) \
            and scene.scenario == "HighwayCutIn" and lane_rel != 0:
        answer = (f"The {desc} is on the acceleration lane of the highway "
                  "to the right of the ego vehicle.")

    return (_entry(question, answer, 4, 0, "perception", tags),
            pointing_towards_junction)


# ---------------------------------------------------------------------------
# Question 2: Where is the vehicle going? (:1771-1818)
# ---------------------------------------------------------------------------

def q_vehicle_trajectory(box: Dict, loc_desc: str, desc: str,
                         tags: Sequence[str]) -> Dict:
    question = f"Where is {loc_desc} going?"
    steer = float(box.get("steer", 0.0))
    if steer < -0.1:
        answer = f"The {desc} is turning left."
    elif steer < -0.03:
        answer = f"The {desc} is turning slightly left."
    elif steer > 0.1:
        answer = f"The {desc} is turning right."
    elif steer > 0.03:
        answer = f"The {desc} is turning slightly right."
    else:
        answer = f"The {desc} is going straight."
    if box.get("vehicle_cuts_in"):
        answer = f"The {desc} is cutting into the lane of the ego vehicle."
    return _entry(question, answer, 4, 1, "prediction", tags)


# ---------------------------------------------------------------------------
# Question 3: moving status (:1729-1769)
# ---------------------------------------------------------------------------

def q_vehicle_motion(box: Dict, loc_desc: str, desc: str,
                     tags: Sequence[str]) -> Dict:
    question = f"What is the moving status of {loc_desc}?"
    speed = float(box.get("speed", 0.0))
    is_bike = str(box.get("base_type", "")) == "bicycle"
    if speed < 0.2:
        answer = f"The {desc} is not moving."
    elif speed < 5:
        verb = "moving" if is_bike else "driving"
        answer = f"The {desc} is {verb} slowly."
    else:
        verb = "moving" if is_bike else "driving"
        answer = f"The {desc} is {verb}."
    return _entry(question, answer, 4, 2, "prediction", tags)


# ---------------------------------------------------------------------------
# Question 4: path crossing (:1544-1727)
# ---------------------------------------------------------------------------

def q_path_crossing(scene: Scene, flags: HighwayFlags, box: Dict,
                    loc_desc: str, desc: str,
                    pointing_towards_junction: Optional[bool],
                    tags: Sequence[str]) -> Dict:
    current = scene.current
    djunc = ego_distance_to_junction(scene)
    in_junc = bool(scene.ego_get("is_in_junction"))
    command_int, command_str = crossing_command(current, in_junc, djunc)
    question = (f"The ego vehicle {command_str}. Is {loc_desc} potentially "
                "crossing the path of the ego vehicle?")

    next_road_ids = list(scene.ego_get("next_road_ids", []) or [])
    next_next = list(scene.ego_get("next_next_road_ids_ego", []) or [])
    veh_next_roads = list(box.get("next_road_ids", []) or [])
    same_future_road = any(r in next_road_ids for r in veh_next_roads)
    lane_rel = lane_relative_to_ego(box)
    same_dir = same_direction_as_ego(box)
    role = str(box.get("role_name", ""))
    dist = box_distance(box)

    # the leading actor (reference reads affects_ego_10/15/20)
    actor_in_front_id = None
    if scene.ego_get("hazard_detected_20"):
        for key in ("affects_ego_10", "affects_ego_15", "affects_ego_20"):
            if scene.ego_get(key):
                actor_in_front_id = scene.ego_get(key)
                break
    if actor_in_front_id is None and lane_rel == 0 and same_dir \
            and 0 < float(np.asarray(box.get("position", [0, 0]),
                                     float)[0]) and dist < 20 \
            and scene.ego_get("hazard_detected_20") is None:
        # geometric fallback when the collector didn't record the ladder
        actor_in_front_id = box.get("id")

    if actor_in_front_id is not None and actor_in_front_id == box.get("id") \
            and scene.ego_get("lane_type_str") != "Parking":
        answer = (f"Yes, the {desc} is right to the front of the ego "
                  "vehicle, so the ego vehicle should pay attention to "
                  "not crash into it.")
    elif "scenario" in role and scene.scenario == "BlockedIntersection" \
            and dist < 40 and not same_dir:
        answer = (f"Yes, the {desc} is behind the intersection on the road "
                  "the ego vehicle will enter, so the ego vehicle should "
                  "pay attention to not crash into it.")
    elif (box.get("road_id") in next_road_ids
          or box.get("road_id") in next_next or same_future_road) \
            and dist < 25 and not same_dir:
        if box.get("is_in_junction"):
            answer = (f"Yes, the {desc} is inside the upcoming junction on "
                      "the same road as the ego vehicle, so the ego vehicle "
                      "should pay attention to not crash into it.")
        else:
            answer = (f"Yes, the {desc} is behind the intersection on the "
                      "road the ego vehicle will enter, so the ego vehicle "
                      "should pay attention to not crash into it.")
    elif box.get("is_in_junction") and djunc < 40 and points_towards_ego(box):
        deg = np.degrees(float(box.get("yaw", 0.0))) % 360.0
        if 160 < deg < 200 and command_int == 3:
            answer = ("If the other vehicle keeps going straight, the "
                      "routes will not cross.")
        else:
            answer = f"Yes, the {desc} is crossing the path of the ego vehicle."
    elif box.get("vehicle_cuts_in"):
        answer = (f"Yes, the routes will cross since the {desc} is cutting "
                  "into the lane of the ego vehicle.")
    elif pointing_towards_junction and djunc < 40:
        answer = (f"Yes, the {desc} might cross the path of the ego "
                  "vehicle, depending on which way the vehicle is going "
                  "to turn.")
    elif scene.ego_get("lane_type_str") == "Parking" and lane_rel == -1 \
            and dist < 10:
        answer = ("Yes, because the ego vehicle wants to exit the parking "
                  f"spot and the {desc} is on the lane the ego vehicle "
                  "wants to enter.")
    else:
        answer = f"No, the {desc} is not crossing paths with the ego vehicle."

    if lane_rel == -1 and command_int == 5:
        answer = (f"Yes, the {desc} is crossing paths with the ego vehicle "
                  "because the ego vehicle does a lane change to the left "
                  f"onto the lane of the {desc}.")
    elif lane_rel == 1 and command_int == 6:
        answer = (f"Yes, the {desc} is crossing paths with the ego vehicle "
                  "because the ego vehicle does a lane change to the right "
                  f"onto the lane of the {desc}.")
    elif "scenario" in role and flags.is_highway and flags.accel_lane:
        answer = (f"The routes of the ego vehicle and the {desc} might "
                  f"cross as the {desc} is on the highway and the ego "
                  "vehicle is on the acceleration lane about to enter "
                  "the highway.")
    elif "scenario" in role and flags.is_highway and flags.other_accel_lane:
        answer = (f"The routes of the ego vehicle and the {desc} might "
                  f"cross as the {desc} is on the acceleration lane about "
                  "to enter the highway, potentially cutting into the lane "
                  "of the ego vehicle.")

    is_bike = str(box.get("base_type", "")) == "bicycle"
    if "scenario" in role and is_bike \
            and scene.scenario == "CrossingBicycleFlow":
        if command_int == 4:
            command_str = "turns at the next intersection"
        answer = (f"Yes, the bike lane on which the {desc} is currently "
                  "riding on is crossing paths with the ego vehicle if the "
                  f"ego vehicle {command_str}.")
    elif "scenario" in role and is_bike \
            and scene.scenario == "VehicleTurningRoute":
        answer = (f"Yes, the {desc} will cross paths with the ego vehicle "
                  f"if the ego vehicle {command_str}.")
    elif "scenario" in role and scene.scenario == "HighwayCutIn" \
            and lane_rel == 1:
        answer = (f"Yes, the routes of the ego vehicle and the {desc} "
                  f"might cross as the {desc} is on the acceleration lane, "
                  "potentially cutting into the lane of the ego vehicle.")

    return _entry(question, answer, 4, 3, "planning", tags)


# ---------------------------------------------------------------------------
# Vehicle loop (:2117-2253)
# ---------------------------------------------------------------------------

def vehicle_questions(scene: Scene, flags: HighwayFlags,
                      important_objects: List[str],
                      infos: Dict[str, Dict]) -> List[Dict]:
    out: List[Dict] = []
    for box in scene.vehicles:
        if not should_consider_vehicle(box):
            continue
        color = vehicle_color(box)
        vtype = vehicle_type_name(box)
        pos_str = rough_position(box)
        desc = f"{color}{vtype}"
        loc_desc = f"the {desc} that is {pos_str}"
        important_objects.append(f"the {desc} {pos_str}")
        tag = register_key_object(infos, "Vehicle", desc, box)
        tags = [tag]
        q_pos, pointing = q_vehicle_position(scene, flags, box, loc_desc,
                                             desc, tags)
        out.append(q_pos)
        out.append(q_vehicle_trajectory(box, loc_desc, desc, tags))
        out.append(q_vehicle_motion(box, loc_desc, desc, tags))
        out.append(q_path_crossing(scene, flags, box, loc_desc, desc,
                                   pointing, tags))
    return out


# ---------------------------------------------------------------------------
# Pedestrians (:500-563)
# ---------------------------------------------------------------------------

def close_pedestrians(scene: Scene) -> List[Dict]:
    """LiDAR-dense walkers 1-40 m ahead (reference filter :509-517)."""
    keep = []
    for ped in scene.pedestrians:
        n_pts = ped.get("num_points")
        if n_pts is not None and n_pts < 5:
            continue
        x = float(np.asarray(ped.get("position", [0, 0]), float)[0])
        if x < 1 or x > 40:
            continue
        keep.append(ped)
    return keep


def pedestrian_questions(scene: Scene, important_objects: List[str],
                         infos: Dict[str, Dict]) -> List[Dict]:
    out: List[Dict] = []
    close = close_pedestrians(scene)
    tags = []
    for ped in close:
        pos_str = rough_position(ped, with_distance=False)
        important_objects.append(f"the pedestrian {pos_str}")
        tags.append(register_key_object(infos, "Pedestrian", "pedestrian",
                                        ped))
    n = len(close)
    if n == 0:
        answer = "There are no pedestrians."
    else:
        s = "s" if n > 1 else ""
        are_or_is = "are" if n > 1 else "is"
        answer = f"There {are_or_is} {n} pedestrian{s}."
    out.append(_entry("How many pedestrians are there?", answer,
                      5, 0, "perception", tags))
    # per-pedestrian crossing prediction (extends the reference's count
    # question with the crossing logic its dreamer/commentary modules use)
    for ped, tag in zip(close, tags):
        loc = f"the pedestrian({tag})"
        speed = float(ped.get("speed", 0.0))
        crossing = _ped_crosses(ped) and speed > 0.1
        if crossing:
            a = (f"Yes, {loc} is walking towards the road; the ego vehicle "
                 "must be ready to stop.")
        elif speed > 0.1:
            a = f"No, {loc} is walking away from the ego vehicle's path."
        else:
            a = f"No, {loc} is standing still."
        out.append(_entry(f"Is {loc} about to cross the road?", a,
                          5, 1, "prediction", [tag]))
    return out


def _ped_crosses(box: Dict) -> bool:
    pos = np.asarray(box.get("position", [0, 0]), float)[:2]
    yaw = float(box.get("yaw", 0.0))
    if abs(pos[1]) < 2.0 and pos[0] > 0:
        return True
    direction = np.array([np.cos(yaw), np.sin(yaw)])
    if abs(direction[1]) < 1e-3:
        return False
    t = -pos[1] / direction[1]
    if t <= 0 or t > 40.0:
        return False
    return 0.0 < pos[0] + t * direction[0] < 40.0


# ---------------------------------------------------------------------------
# Stop signs (:565-616)
# ---------------------------------------------------------------------------

def stop_sign_questions(scene: Scene, important_objects: List[str],
                        infos: Dict[str, Dict]
                        ) -> Tuple[List[Dict], Optional[Dict], List[str]]:
    out: List[Dict] = []
    info: Optional[Dict] = None
    tags: List[str] = []
    for ss in scene.stop_signs:
        affects = ss.get("affects_ego")
        if affects is None:  # lighter schema: assume an ahead sign affects
            affects = float(np.asarray(ss.get("position", [0, 0]),
                                       float)[0]) > 0
        if affects and box_distance(ss) < 40:
            important_objects.append("the stop sign")
            tags = [register_key_object(infos, "Traffic element",
                                        "stop sign", ss)]
            info = ss
            break
    question = "Is the ego vehicle affected by a stop sign?"
    if info is not None:
        answer = ("Yes, the ego vehicle is affected by a stop sign, which "
                  "has not been cleared yet.")
    else:
        cleared = [s for s in scene.stop_signs
                   if box_distance(s) < 4 and not s.get("affects_ego")
                   and float(np.asarray(s.get("position", [0, 0]),
                                        float)[0]) > -2.6]
        if cleared:
            answer = ("Yes, the ego vehicle was affected by a stop sign, "
                      "which has already been cleared.")
        else:
            answer = "No, the ego vehicle is not affected by a stop sign."
    out.append(_entry(question, answer, 1, 0, "prediction", tags))
    return out, info, tags


# ---------------------------------------------------------------------------
# Traffic lights (:618-691)
# ---------------------------------------------------------------------------

def traffic_light_questions(scene: Scene, important_objects: List[str],
                            infos: Dict[str, Dict]
                            ) -> Tuple[List[Dict], Optional[Dict], List[str]]:
    out: List[Dict] = []
    info: Optional[Dict] = None
    tags: List[str] = []
    state = ""
    ego_tl_state = str(scene.ego_get("traffic_light_state", "") or "")
    for tl in scene.traffic_lights:
        affects = tl.get("affects_ego")
        if affects is None:
            affects = bool(scene.current.get("light_hazard"))
        if affects and ego_tl_state != "None" and box_distance(tl) < 45:
            state = str(tl.get("state", tl.get("state_str",
                        ego_tl_state or "red")))
            state = state[:1].lower() + state[1:]
            info = tl
            break
    question = "Is the ego vehicle affected by a traffic light?"
    if info is not None:
        answer = "Yes, the ego vehicle is affected by a traffic light."
        important_objects.append(f"the {state} traffic light")
        tags = [register_key_object(infos, "Traffic element",
                                    f"{state} traffic light", info)]
    else:
        answer = "No, the ego vehicle is not affected by a traffic light."
    out.append(_entry(question, answer, 2, 0, "perception", tags))

    question = "What is the state of the traffic light?"
    if info is not None:
        answer = f"The traffic light is {state}."
    else:
        answer = "There is no traffic light affecting the ego vehicle."
    out.append(_entry(question, answer, 2, 1, "prediction", tags))
    if info is not None:
        info = dict(info, state_str=state.capitalize())
    return out, info, tags

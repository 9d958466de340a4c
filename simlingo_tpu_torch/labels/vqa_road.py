"""Road-layout question chain (7 questions).

Copy of `simlingo_tpu/labels/vqa_road.py`.

Behavioral counterpart of reference `carla_vqa_generator.py`
analyze_road_layout (:2435-3178):
  * detect_junction_proximity (:2790-2900) — junction/accel/exit lanes;
  * analyze_important_lanes (:2900-3075) — command-conditioned attention;
  * analyze_lanes_direction (:2735-2790);
  * identify_ego_lane (:2695-2733);
  * analyze_lane_marking (:2625-2695);
  * analyze_ego_lane_change_direction (:2546-2625);
  * lane_change_analysis (:2457-2546) — other vehicles into ego lane.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from simlingo_tpu_torch.labels.vqa_scene import (HighwayFlags, Scene,
                                           ego_distance_to_junction,
                                           number_to_word,
                                           register_key_object)
from simlingo_tpu_torch.labels.vqa_vehicles import _entry

# carla.LaneChange enum values
LANE_CHANGE_NONE, LANE_CHANGE_RIGHT, LANE_CHANGE_LEFT, LANE_CHANGE_BOTH = \
    0, 1, 2, 3

# carla.LaneMarkingType int codes -> words (reference :2640-2662); the
# repo's collector records the enum *name* string instead, so both are
# accepted.
_MARKING_BY_INT = {1: "broken", 2: "solid", 3: "double solid",
                   4: "solid broken", 5: "broken solid", 6: "double broken",
                   9: "curb", 10: None}
_MARKING_BY_NAME = {"broken": "broken", "solid": "solid",
                    "solidsolid": "double solid",
                    "solidbroken": "solid broken",
                    "brokensolid": "broken solid",
                    "brokenbroken": "double broken", "curb": "curb",
                    "grass": "grass", "none": None, "": None,
                    "other": "other"}


def _marking_word(value) -> Optional[str]:
    if value is None:
        return None
    if isinstance(value, (int, np.integer)):
        return _MARKING_BY_INT.get(int(value), None)
    return _MARKING_BY_NAME.get(str(value).lower(), str(value).lower())


def _marking(scene: Scene, side: str) -> Optional[str]:
    for key in (f"{side}_lane_marking_type", f"lane_marking_{side}"):
        v = scene.ego_get(key)
        if v is not None:
            return _marking_word(v)
    return None


def _marking_color(scene: Scene, side: str) -> str:
    for key in (f"{side}_lane_marking_color_str",
                f"lane_marking_{side}_color"):
        v = scene.ego_get(key)
        if v:
            s = str(v)
            return s[:1].lower() + s[1:]
    return "white"


def _lane_change_flag(scene: Scene) -> int:
    v = scene.ego_get("lane_change")
    if v is not None:
        return int(v)
    # derive from markings: a broken marking on a side permits the change
    left = _marking(scene, "left") or ""
    right = _marking(scene, "right") or ""
    allowed_left = "broken" in left
    allowed_right = "broken" in right
    if allowed_left and allowed_right:
        return LANE_CHANGE_BOTH
    if allowed_left:
        return LANE_CHANGE_LEFT
    if allowed_right:
        return LANE_CHANGE_RIGHT
    return LANE_CHANGE_NONE


def _overtaking(scene: Scene) -> bool:
    return bool(scene.current.get("changed_route")) \
        and "TwoWays" in scene.scenario


# ---------------------------------------------------------------------------
# Is the ego vehicle at a junction? (:2790-2900)
# ---------------------------------------------------------------------------

def junction_question(scene: Scene, flags: HighwayFlags,
                      important_objects: List[str],
                      infos: Dict[str, Dict]) -> Tuple[Dict, bool]:
    question = "Is the ego vehicle at a junction?"
    djunc = ego_distance_to_junction(scene)
    in_junc = bool(scene.ego_get("is_in_junction"))
    is_junction = False

    def add_junction_object(label):
        important_objects.append(label)
        register_key_object(infos, "Traffic element", "Junction")

    if flags.accel_lane:
        answer = ("The ego vehicle is on an acceleration lane and about "
                  "to enter the highway.")
        add_junction_object("a highway entry")
    elif flags.other_accel_lane:
        answer = "The ego vehicle is on the highway close to the entry lane."
    elif flags.exit_lane:
        answer = ("The ego vehicle is on an exit lane and about to exit "
                  "the highway.")
        add_junction_object("a highway exit")
    elif flags.about_to_exit:
        answer = "The ego vehicle is on the highway close to the exit lane."
    elif flags.is_highway and in_junc:
        answer = ("The ego vehicle is on the highway potentially close "
                  "to a junction.")
        add_junction_object("a junction")
    elif in_junc:
        is_junction = True
        answer = "The ego vehicle is in a junction."
        add_junction_object("a junction")
    elif djunc < 25:
        answer = "The ego vehicle is right before a junction."
        add_junction_object("a junction")
    else:
        answer = "No, the ego vehicle is not at a junction."

    if scene.scenario == "InterurbanActorFlow":
        command = int(scene.current.get("command", 4))
        next_command = int(scene.current.get("next_command", 4))
        if command == 5 and next_command != 1:
            answer = ("The ego vehicle is on an interurban road close to a "
                      "point where a new turning lane emerges.")
        elif command == 5 and next_command == 1 and djunc < 35:
            answer = "The ego vehicle is on a turning lane close to a junction."
        elif command == 5 and next_command == 1:
            answer = "The ego vehicle is on a turning lane approaching a junction."

    return _entry(question, answer, 3, 0, "perception", []), is_junction


# ---------------------------------------------------------------------------
# Important lanes to watch (:2900-3075)
# ---------------------------------------------------------------------------

def _command_description(scene: Scene, flags: HighwayFlags
                         ) -> Tuple[str, int, int, bool]:
    m = scene.current
    command_int = int(m.get("command", 4))
    next_command_int = int(m.get("next_command", 4))
    lane_change_soon = False
    command_str = {
        1: "go left at the next intersection",
        2: "go right at the next intersection",
        3: "go straight at the next intersection",
        4: "follow the road",
        5: "do a lane change to the left",
        6: "do a lane change to the right",
    }[command_int]
    if next_command_int in (5, 6):
        tp_next = np.asarray(m.get("target_point_next", [999.0, 999.0]),
                             float)
        if float(np.hypot(tp_next[0], tp_next[1])) < 20:
            side = "left" if next_command_int == 5 else "right"
            command_str = f"do a lane change to the {side} soon"
            lane_change_soon = True
    if flags.about_to_exit or flags.about_to_exit_far:
        command_str = "exit the highway"
    return command_str, command_int, next_command_int, lane_change_soon


def important_lanes_question(scene: Scene, flags: HighwayFlags,
                             is_junction: bool) -> Dict:
    ego = scene
    command_str, command_int, next_command_int, lane_change_soon = \
        _command_description(scene, flags)
    question = (f"The ego vehicle wants to {command_str}. Which lanes are "
                "important to watch out for?")
    n_same = int(ego.ego_get("num_lanes_same_direction", 1) or 1)
    n_opp = int(ego.ego_get("num_lanes_opposite_direction", 0) or 0)
    lane_num = int(ego.ego_get("ego_lane_number", 0) or 0)
    lane_change = _lane_change_flag(scene)
    answer = ""

    if command_int == 1:
        answer = ("The ego vehicle should pay particular attention to "
                  "traffic coming from the left side of the intersection "
                  "and is going straight or turning left, traffic coming "
                  "from the right and going straight or turning left and "
                  "to oncoming traffic.")
    elif command_int == 2:
        answer = ("The ego vehicle should pay particular attention to "
                  "traffic coming straight ahead from the left side of the "
                  "intersection and to oncoming traffic turning left.")
    elif command_int == 3:
        if flags.is_highway:
            if lane_change == LANE_CHANGE_NONE:
                if flags.other_accel_lane:
                    answer = ("The ego vehicle should pay particular "
                              "attention to the vehicle on the acceleration "
                              "lane to the right.")
                else:
                    answer = ("Since there are no lane changes allowed, the "
                              "ego does not need to pay particular attention "
                              "to any neighboring lane.")
            else:
                add = {LANE_CHANGE_RIGHT:
                       "to the right lane of the highway.",
                       LANE_CHANGE_LEFT: "to the left lane of the highway.",
                       LANE_CHANGE_BOTH:
                       "to both neighboring lanes of the highway."}[
                           lane_change]
                if flags.other_accel_lane:
                    answer = ("The ego vehicle should pay particular "
                              "attention to the vehicle on the acceleration "
                              "lane to the right and " + add)
                else:
                    answer = ("The ego vehicle should pay particular "
                              "attention to " + add)
        else:
            answer = ("The ego vehicle should pay particular attention to "
                      "traffic coming from the left side of the "
                      "intersection and is going straight or turning left, "
                      "traffic coming from the right and going straight or "
                      "turning right and to oncoming traffic turning left.")
    elif command_int == 4 and not lane_change_soon:
        parking = (ego.ego_get("parking_left")
                   or ego.ego_get("parking_right"))
        if is_junction:
            answer = ("The ego vehicle should pay attention to other "
                      "vehicles in the junction.")
        elif n_same == 1 and n_opp == 0:
            if parking:
                answer = ("There are no other driving lanes to watch out "
                          "for since the ego vehicle is on a one lane road. "
                          "But the ego vehicle should watch out for the "
                          "parking lane.")
            else:
                answer = ("There are no other driving lanes to watch out "
                          "for since the ego vehicle is on a one lane road.")
        elif n_same == 1 and n_opp >= 1:
            if parking:
                answer = ("The ego vehicle should watch out for traffic "
                          "coming from the oncoming lane and for the "
                          "parking lane.")
            else:
                answer = ("The ego vehicle should watch out for traffic "
                          "coming from the oncoming lane.")
        elif n_same > 1 and n_opp == 0:
            answer = ("The ego vehicle should pay particular attention to "
                      "traffic changing lanes from neighboring lanes.")
        else:
            if lane_num == 0:
                answer = ("The ego vehicle should pay particular attention "
                          "to traffic changing lanes from neighboring lanes "
                          "and for traffic coming from the oncoming lane.")
            else:
                answer = ("The ego vehicle should pay particular attention "
                          "to traffic changing lanes from neighboring "
                          "lanes.")
    elif command_int == 5 or (next_command_int == 5 and lane_change_soon):
        if lane_change_soon:
            answer = ("The ego vehicle should pay particular attention to "
                      "traffic in the left-hand lane and position itself so "
                      "that no vehicle is driving on the same height to "
                      "prepare for the lane change.")
        else:
            answer = ("The ego vehicle should pay particular attention to "
                      "traffic in the left-hand lane and wait for a gap to "
                      "change lanes.")
    elif command_int == 6 or (next_command_int == 6 and lane_change_soon):
        if lane_change_soon:
            answer = ("The ego vehicle should pay particular attention to "
                      "traffic in the right-hand lane and position itself "
                      "so that no vehicle is driving on the same height to "
                      "prepare for the lane change.")
        else:
            answer = ("The ego vehicle should pay particular attention to "
                      "traffic in the right-hand lane and wait for a gap to "
                      "change lanes.")

    if ego.ego_get("bike_lane_left") and n_opp == 0 and lane_num == 0:
        answer += (" Additionally, the ego vehicle should have an eye on "
                   "the bike lane on the left side.")
    elif ego.ego_get("bike_lane_right"):
        answer += (" Additionally, the ego vehicle should have an eye on "
                   "the bike lane on the right side.")

    if flags.accel_lane and command_int == 5:
        answer = ("The ego vehicle should pay particular attention to "
                  "traffic on the rightmost lane of the highway, adjust "
                  "its speed, and position itself so that no vehicle is "
                  "driving on the same height to prepare for the lane "
                  "change.")
    elif flags.accel_lane and command_int == 6:
        answer = ("The ego vehicle should pay particular attention to "
                  "traffic on the leftmost lane of the highway, adjust its "
                  "speed, and position itself so that no vehicle is "
                  "driving on the same height to prepare for the lane "
                  "change.")
    elif flags.accel_lane:
        answer = ("The ego vehicle should pay particular attention to the "
                  "traffic on the highway, which is close to the "
                  "acceleration lane.")
    elif flags.about_to_exit:
        answer = ("The ego vehicle should pay particular attention to the "
                  "traffic on the exit lane, since they might slow down.")
    elif flags.about_to_exit_far:
        answer = ("The ego vehicle is still far away from the exit lane, "
                  "so it should pay attention to the traffic on the "
                  "highway.")

    if scene.scenario == "InterurbanActorFlow":
        command = int(scene.current.get("command", 4))
        next_command = int(scene.current.get("next_command", 4))
        if command == 5 and next_command != 1:
            answer = ("The ego vehicle should pay particular attention to "
                      "the traffic on the turning lane, since they might "
                      "slow down.")
        elif command == 5 and next_command == 1:
            answer = ("The ego vehicle should pay particular attention to "
                      "the traffic on the turning lane as they might slow "
                      "down and to oncoming traffic the ego vehicle needs "
                      "to cross in order to turn left.")
        elif command == 1:
            answer = ("The ego vehicle should pay particular attention to "
                      "oncoming traffic the ego vehicle needs to cross in "
                      "order to turn left.")

    if ego.ego_get("lane_type_str") == "Parking":
        answer = ("The ego vehicle should pay particular attention to the "
                  "traffic in the lane into which the ego vehicle wants to "
                  "enter from the parking space.")
    if _overtaking(scene):
        answer = ("The ego vehicle should keep driving regardless of other "
                  "vehicles since it overtakes an obstruction.")
    return _entry(question, answer, 3, 1, "prediction", [])


# ---------------------------------------------------------------------------
# Lane counts (:2735-2790)
# ---------------------------------------------------------------------------

def lanes_direction_questions(scene: Scene, is_junction: bool) -> List[Dict]:
    out = []
    n_same = scene.ego_get("num_lanes_same_direction")
    n_opp = scene.ego_get("num_lanes_opposite_direction")
    for count, name in ((n_same, "same"), (n_opp, "opposite")):
        if count is None:
            continue
        count = int(count)
        if scene.ego_get("lane_type_str") == "Parking" and name == "same":
            count -= 1
        to_or_as = "to" if name == "opposite" else "as"
        question = (f"How many lanes are there in the {name} direction "
                    f"{to_or_as} the ego car?")
        if is_junction:
            answer = ("It is not possible to tell since the ego vehicle "
                      "is in a junction.")
        elif count == 0:
            answer = f"There are no lanes in the {name} direction."
        else:
            s = "s" if count > 1 else ""
            are_or_is = "are" if count > 1 else "is"
            answer = (f"There {are_or_is} {number_to_word(count)} "
                      f"lane{s} in the {name} direction.")
        out.append(_entry(question, answer, 3, 2, "perception", []))
    return out


# ---------------------------------------------------------------------------
# Ego lane index (:2695-2733)
# ---------------------------------------------------------------------------

def ego_lane_question(scene: Scene, is_junction: bool) -> Optional[Dict]:
    lane_num = scene.ego_get("ego_lane_number")
    if lane_num is None:
        return None
    lane_num = int(lane_num)
    question = ("On which lane is the ego vehicle (left most lane of the "
                "lanes going in the same direction is indicated with 0)?")
    answer = f"The ego vehicle is on lane {lane_num}."
    if scene.ego_get("lane_type_str") == "Parking":
        answer = (f"The ego vehicle is on lane {lane_num} which is the "
                  "parking lane.")
    if is_junction:
        answer = ("It is not possible to tell since the ego vehicle is "
                  "in a junction.")
    if _overtaking(scene):
        answer = (f"The ego vehicle is on lane {lane_num + 1} since it "
                  "overtakes an obstruction.")
    return _entry(question, answer, 3, 3, "perception", [])


# ---------------------------------------------------------------------------
# Lane markings (:2625-2695)
# ---------------------------------------------------------------------------

def lane_marking_questions(scene: Scene) -> List[Dict]:
    out = []
    for side in ("left", "right"):
        word = _marking(scene, side)
        if word is None and scene.ego_get(f"lane_marking_{side}") is None \
                and scene.ego_get(f"{side}_lane_marking_type") is None:
            continue
        question = f"What lane marking is on the {side} side of the ego car?"
        if word is None:
            answer = (f"There is no lane marking on the {side} side of "
                      "the ego car.")
        else:
            color = _marking_color(scene, side)
            if color == "other" or word == "other":
                description = word
            else:
                description = f"{color} {word} lane"
            answer = (f"The lane marking on the {side} side of the ego car "
                      f"is a {description}.")
        if _overtaking(scene):
            if side == "right":
                # ego drives on the opposite lane: its right marking is the
                # original lane's left marking
                left_word = _marking(scene, "left") or "broken"
                color = _marking_color(scene, "left")
                description = (left_word if color == "other"
                               else f"{color} {left_word} lane")
                answer = ("The lane marking on the right side of the ego "
                          f"car is a {description}.")
            else:
                answer = ("It is not possible to tell since the ego "
                          "vehicle overtakes an obstruction.")
        out.append(_entry(question, answer, 3, 4, "perception", []))
    return out


# ---------------------------------------------------------------------------
# Ego lane-change permissions (:2546-2625)
# ---------------------------------------------------------------------------

def ego_lane_change_question(scene: Scene, flags: HighwayFlags,
                             is_junction: bool) -> Dict:
    question = "In which direction is the ego car allowed to change lanes?"
    lane_change = _lane_change_flag(scene)
    n_same = int(scene.ego_get("num_lanes_same_direction", 1) or 1)
    n_opp = int(scene.ego_get("num_lanes_opposite_direction", 0) or 0)
    command_int = int(scene.current.get("command", 4))

    if flags.accel_lane and command_int == 5:
        answer = ("The ego vehicle is allowed to change lanes to the left "
                  "to enter the highway.")
    elif lane_change == LANE_CHANGE_NONE:
        if n_same == 1:
            answer = ("The ego vehicle can not change lanes since it is "
                      "on a one lane road.")
        else:
            answer = ("The ego vehicle is not allowed to change lanes to "
                      "another driving lane.")
    elif lane_change == LANE_CHANGE_RIGHT:
        answer = "The ego vehicle is allowed to change lanes to the right."
    elif lane_change == LANE_CHANGE_LEFT:
        answer = "The ego vehicle is allowed to change lanes to the left."
    else:
        answer = ("The ego vehicle is allowed to change lanes to the left "
                  "and right.")

    parking_left = bool(scene.ego_get("parking_left"))
    parking_right = bool(scene.ego_get("parking_right"))
    if parking_left and parking_right and lane_change == LANE_CHANGE_NONE:
        if n_opp >= 1:
            answer += (" But it could change to the parking lane on the "
                       "right side of the road.")
        else:
            answer += (" But it could change to the parking lane on the "
                       "left and right side of the road.")
    elif parking_left and lane_change not in (LANE_CHANGE_LEFT,
                                              LANE_CHANGE_BOTH) \
            and n_opp == 0:
        joiner = ("But it could" if lane_change == LANE_CHANGE_NONE
                  else "It could also")
        answer += (f" {joiner} change to the parking lane on the left side "
                   "of the road.")
    elif parking_right and lane_change not in (LANE_CHANGE_RIGHT,
                                               LANE_CHANGE_BOTH):
        joiner = ("But it could" if lane_change == LANE_CHANGE_NONE
                  else "It could also")
        answer += (f" {joiner} change to the parking lane on the right "
                   "side of the road.")

    if scene.ego_get("lane_type_str") == "Parking":
        answer = ("The ego vehicle is on a parking lane and is allowed to "
                  "merge into the driving lane.")
    if is_junction:
        answer = ("It is not possible to tell since the ego vehicle is "
                  "in a junction.")
    if _overtaking(scene):
        answer = ("The ego vehicle overtakes an obstruction. It is not "
                  "expected to change lanes.")
    return _entry(question, answer, 3, 5, "prediction", [])


# ---------------------------------------------------------------------------
# Other vehicles into the ego lane (:2457-2546)
# ---------------------------------------------------------------------------

def others_lane_change_question(scene: Scene, flags: HighwayFlags,
                                is_junction: bool) -> Dict:
    question = ("From which side are other vehicles allowed to change "
                "lanes into the ego lane?")
    lane_change = _lane_change_flag(scene)
    n_same = int(scene.ego_get("num_lanes_same_direction", 1) or 1)
    n_opp = int(scene.ego_get("num_lanes_opposite_direction", 0) or 0)
    command_int = int(scene.current.get("command", 4))

    if flags.accel_lane and command_int == 5:
        answer = ("Vehicles could potentially change lanes from the left "
                  "side but it is very unlikely since the ego vehicle is "
                  "on an acceleration lane.")
    elif lane_change == LANE_CHANGE_NONE:
        if n_same == 1:
            answer = ("There are no lane changes possible since the ego "
                      "vehicle is on a one lane road.")
        else:
            answer = ("There are no lane changes allowed from another "
                      "driving lane into the ego lane.")
    elif lane_change == LANE_CHANGE_RIGHT:
        answer = "Vehicles are allowed to change lanes from the right side."
    elif lane_change == LANE_CHANGE_LEFT:
        answer = "Vehicles are allowed to change lanes from the left side."
    else:
        answer = "Vehicles are allowed to change lanes from both sides."

    parking_left = bool(scene.ego_get("parking_left"))
    parking_right = bool(scene.ego_get("parking_right"))
    if parking_left and parking_right and lane_change == LANE_CHANGE_NONE:
        if n_opp >= 1:
            answer += (" But vehicles that are parked on the right side of "
                       "the road are allowed to change lanes into the ego "
                       "lane.")
        else:
            answer += (" But vehicles that are parked on the left and "
                       "right side of the road are allowed to change lanes "
                       "into the ego lane.")
    elif parking_left and lane_change not in (LANE_CHANGE_LEFT,
                                              LANE_CHANGE_BOTH) \
            and n_opp == 0:
        joiner = ("But" if lane_change == LANE_CHANGE_NONE else "And")
        answer += (f" {joiner} vehicles that are parked on the left side "
                   "of the road are allowed to change lanes into the ego "
                   "lane.")
    elif parking_right and lane_change not in (LANE_CHANGE_RIGHT,
                                               LANE_CHANGE_BOTH):
        joiner = ("But" if lane_change == LANE_CHANGE_NONE else "And")
        answer += (f" {joiner} vehicles that are parked on the right side "
                   "of the road are allowed to change lanes into the ego "
                   "lane.")

    if scene.ego_get("lane_type_str") == "Parking":
        answer = ("The ego vehicle is on a parking lane and vehicles only "
                  "enter the lane to park.")
    if is_junction:
        answer = ("It is not possible to tell since the ego vehicle is "
                  "in a junction.")
    if _overtaking(scene):
        answer = ("The ego vehicle overtakes an obstruction. We do not "
                  "expect vehicles to change into the ego lane.")
    return _entry(question, answer, 3, 6, "prediction", [])


def road_layout_questions(scene: Scene, flags: HighwayFlags,
                          important_objects: List[Dict],
                          infos: Dict[str, Dict]) -> List[Dict]:
    out: List[Dict] = []
    junction_entry, is_junction = junction_question(scene, flags,
                                                    important_objects, infos)
    out.append(junction_entry)
    out.append(important_lanes_question(scene, flags, is_junction))
    out.extend(lanes_direction_questions(scene, is_junction))
    lane_entry = ego_lane_question(scene, is_junction)
    if lane_entry is not None:
        out.append(lane_entry)
    out.extend(lane_marking_questions(scene))
    out.append(ego_lane_change_question(scene, flags, is_junction))
    out.append(others_lane_change_question(scene, flags, is_junction))
    return out

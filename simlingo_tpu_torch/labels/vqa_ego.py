"""Ego-action question chain: braking, traffic-element actions, obstruction
lane changes, speed limit.

Copy of `simlingo_tpu/labels/vqa_ego.py`.

Behavioral counterpart of reference `carla_vqa_generator.py`
generate_ego_vehicle_actions (:703-1514):
  * determine_braking_requirement (:790-1106) — scenario-conditioned
    "Does the ego vehicle need to brake? Why?";
  * determine_ego_action_based_on_actor (:1108-1228) — distance-laddered
    traffic-light / stop-sign planning;
  * determine_whether_ego_needs_to_change_lanes_due_to_obstruction
    (:1230-1476) — obstruction analysis + "Is there an obstacle on the
    current road?";
  * add_speed_limit_question (:733-756).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simlingo_tpu_torch.labels.vqa_scene import (HighwayFlags, Scene, box_distance,
                                           should_consider_vehicle,
                                           tags_for_box, register_key_object,
                                           rough_position, vehicle_color,
                                           vehicle_type_name)
from simlingo_tpu_torch.labels.vqa_vehicles import _entry

HIGHWAY_SCENARIOS = (
    "EnterActorFlow", "EnterActorFlowV2", "HighwayCutIn", "HighwayExit",
    "MergerIntoSlowTraffic", "MergerIntoSlowTrafficV2",
    "YieldToEmergencyVehicle",
)

# obstacle nouns per scenario (reference :1345-1356)
OBSTACLE_NOUNS = {
    "Accident": "accident", "AccidentTwoWays": "accident",
    "ConstructionObstacle": "construction warning",
    "ConstructionObstacleTwoWays": "construction warning",
    "InvadingTurn": "invading vehicles on the opposite lane",
    "HazardAtSideLane": "two bicycles",
    "HazardAtSideLaneTwoWays": "two bicycles",
    "ParkedObstacle": "parked vehicle",
    "ParkedObstacleTwoWays": "parked vehicle",
    "VehicleOpensDoorTwoWays": "vehicle with the opened door",
}


def _rough_pos_of_it(box: Dict) -> str:
    y = float(np.asarray(box.get("position", [0, 0]), float)[1])
    if -2 <= y <= 2:
        return "to the front of it"
    if y > 2:
        return "to the front right"
    return "to the front left"


def _vehicle_phrase(box: Dict) -> str:
    return f"{vehicle_color(box)}{vehicle_type_name(box)}"


# ---------------------------------------------------------------------------
# Does the ego vehicle need to brake? Why? (:790-1106)
# ---------------------------------------------------------------------------

def braking_question(scene: Scene, infos: Dict[str, Dict],
                     tl_info: Optional[Dict],
                     ss_info: Optional[Dict]) -> Dict:
    m = scene.current
    vehicles = scene.vehicles_by_id
    scenario = scene.scenario
    question = "Does the ego vehicle need to brake? Why?"
    answer = "There is no reason for the ego vehicle to brake."
    tags: List[str] = []

    speed = float(m.get("speed", 0.0))
    speed_limit = float(m.get("speed_limit", 30.0 / 3.6))
    reduced_id = m.get("speed_reduced_by_obj_id")
    reduced_type = m.get("speed_reduced_by_obj_type")
    reduced_dist = m.get("speed_reduced_by_obj_distance")
    slowed = (m.get("control_brake") or m.get("brake")
              or (speed < 0.9 * 0.72 * speed_limit
                  and reduced_id is not None
                  and (reduced_dist or 0.0) < 40
                  and float(m.get("target_speed", speed)) < speed))

    if slowed:
        if reduced_type is None:
            target = 0.72 * speed_limit
            if scene.ego_get("is_in_junction"):
                target = 64.0 / 3.6
            if target > 0 and speed / target > 1.031266635497984:
                answer = "The ego vehicle should brake because it is too fast."
        elif reduced_type == "traffic.stop":
            answer = "The ego vehicle should stop because of the stop sign."
            tags = tags_for_box(infos, ss_info)
        elif reduced_type == "traffic.traffic_light":
            answer = ("The ego vehicle should stop because of the traffic "
                      "light that is red.")
            tags = tags_for_box(infos, tl_info)
        elif m.get("walker_hazard"):
            peds = scene.pedestrians
            if peds:
                closest = min(peds, key=box_distance)
                verb = "stop" if box_distance(closest) < 10 else "slow down"
                tags = tags_for_box(infos, closest)
            else:
                verb = "slow down"
            noun = ("pedestrians that are crossing the road"
                    if len(peds) > 1
                    else "pedestrian that is crossing the road")
            answer = f"The ego vehicle should {verb} because of the {noun}."
        else:
            answer, tags = _braking_for_vehicle_hazard(
                scene, infos, reduced_id, reduced_type, answer, tags)

    else:
        leading_id = scene.ego_get("affects_ego_40")
        if leading_id is not None and leading_id in vehicles:
            leading = vehicles[leading_id]
            if should_consider_vehicle(leading):
                if speed < 0.72 * 0.9 * speed_limit \
                        and float(m.get("throttle", 0.0)) < 0.9:
                    tags = tags_for_box(infos, leading)
                    answer = ("The ego vehicle should adjust its speed to "
                              f"the speed of the {_vehicle_phrase(leading)} "
                              f"that is {_rough_pos_of_it(leading)}.")
            if "scenario" in str(leading.get("role_name", "")) \
                    and box_distance(leading) < 15 \
                    and scenario == "BlockedIntersection":
                tags = tags_for_box(infos, leading)
                answer = ("The ego vehicle should stop because of the "
                          f"{_vehicle_phrase(leading)} that is "
                          f"{_rough_pos_of_it(leading)} and is blocking "
                          "the intersection.")

    if answer == "There is no reason for the ego vehicle to brake." \
            and m.get("control_brake"):
        answer, tags = _braking_lane_change_scenarios(scene, infos,
                                                      answer, tags)

    if answer == "There is no reason for the ego vehicle to brake." \
            and ss_info is not None and ss_info.get("affects_ego", True) \
            and box_distance(ss_info) < 40:
        answer = "The ego vehicle should slow down and stop at the stop sign."
        tags = tags_for_box(infos, ss_info)

    # repo measurement schema uses plain hazard flags; keep a readable
    # fallback so lighter frames still get a grounded answer
    if answer == "There is no reason for the ego vehicle to brake." \
            and (m.get("brake") or m.get("control_brake")):
        if m.get("light_hazard"):
            answer = ("The ego vehicle should stop because of the traffic "
                      "light that is red.")
        elif m.get("stop_sign_hazard"):
            answer = "The ego vehicle should stop because of the stop sign."

    return _entry(question, answer, 6, 0, "planning", tags)


def _braking_for_vehicle_hazard(scene: Scene, infos: Dict[str, Dict],
                                reduced_id, reduced_type, answer: str,
                                tags: List[str]) -> Tuple[str, List[str]]:
    m = scene.current
    scenario = scene.scenario
    vehicles = scene.vehicles_by_id

    def scenario_vehicle(pred) -> Optional[Dict]:
        cands = [v for v in vehicles.values()
                 if "scenario" in str(v.get("role_name", "")) and pred(v)]
        return min(cands, key=box_distance) if cands else None

    if "AccidentTwoWays" in scenario \
            and reduced_type == "vehicle.dodge.charger_police_2020":
        police = scenario_vehicle(
            lambda v: v.get("type_id") == "vehicle.dodge.charger_police_2020")
        if police is not None:
            tags = tags_for_box(infos, police)
        return ("The ego vehicle should stop because it must invade the "
                "opposite lane, which is occupied, in order to bypass "
                "the accident.", tags)
    if "ConstructionObstacleTwoWays" in scenario \
            and reduced_type == "static.prop.trafficwarning":
        warn = [s for s in scene.static_objects
                if s.get("class") == "static_trafficwarning"
                or "trafficwarning" in str(s.get("type_id", ""))]
        if warn:
            tags = tags_for_box(infos, warn[0])
        return ("The ego vehicle should stop because it must invade the "
                "opposite lane, which is occupied, in order to bypass "
                "the construction warning.", tags)
    scenario_obj = (reduced_id in vehicles and "scenario"
                    in str(vehicles[reduced_id].get("role_name", "")))
    if "ParkedObstacleTwoWays" in scenario and scenario_obj:
        tags = tags_for_box(infos, vehicles[reduced_id])
        return ("The ego vehicle should stop because it must invade the "
                "opposite lane, which is occupied, in order to bypass "
                "the parked vehicle.", tags)
    if "VehicleOpensDoorTwoWays" in scenario and scenario_obj:
        tags = tags_for_box(infos, vehicles[reduced_id])
        return ("The ego vehicle should stop because it must invade the "
                "opposite lane, which is occupied, in order to bypass "
                "the vehicle with the opened doors.", tags)
    if "HazardAtSideLaneTwoWays" in scenario and scenario_obj:
        tags = tags_for_box(infos, vehicles[reduced_id])
        return ("The ego vehicle should stop because it must invade the "
                "opposite lane, which is occupied, in order to bypass "
                "the bicycles.", tags)
    if reduced_id not in vehicles:
        return answer, tags

    hazard = vehicles[reduced_id]
    brake_due_to_leading = not m.get("vehicle_hazard")
    speed_limit_kmh = int(float(m.get("speed_limit", 0.0)) * 3.6)
    is_highway = scenario in HIGHWAY_SCENARIOS and speed_limit_kmh > 50
    phrase = _vehicle_phrase(hazard)
    pos_str = _rough_pos_of_it(hazard)
    brake_stop = "stop" if float(hazard.get("speed", 0.0)) < 0.5 else "brake"
    consider = should_consider_vehicle(hazard)
    n_pts = hazard.get("num_points", 999)

    if n_pts < 3 or not consider:
        answer = "There is no reason for the ego vehicle to brake."
    elif brake_due_to_leading:
        tags = tags_for_box(infos, hazard)
        if float(hazard.get("speed", 0.0)) < 0.5:
            answer = (f"The ego vehicle should stop because of the {phrase} "
                      f"that is {pos_str}.")
        else:
            answer = ("The ego vehicle should adjust its speed to the "
                      f"speed of the {phrase} that is {pos_str}.")
    elif is_highway:
        tags = tags_for_box(infos, hazard)
        answer = (f"The ego vehicle should {brake_stop} because of the "
                  f"{phrase} that is {pos_str}.")
    else:
        near_junction = (scene.ego_get("is_in_junction")
                         or (scene.ego_get("distance_to_junction") is not None
                             and float(scene.ego_get("distance_to_junction"))
                             < 10))
        different_road = hazard.get("road_id") is not None \
            and hazard.get("road_id") != scene.ego_get("road_id")
        if near_junction and different_road:
            y = float(np.asarray(hazard.get("position", [0, 0]), float)[1])
            if y < -8:
                where = "on the left side of the junction"
            elif y > 8:
                where = "on the right side of the junction"
            else:
                where = "on the opposite side of the junction"
            tags = tags_for_box(infos, hazard)
            answer = (f"The ego vehicle should {brake_stop} because of the "
                      f"{phrase} that is {where}.")
        elif hazard.get("vehicle_cuts_in"):
            tags = tags_for_box(infos, hazard)
            answer = (f"The ego vehicle should {brake_stop} because of the "
                      f"{phrase} that is cutting into the ego vehicle's "
                      "lane.")
        else:
            tags = tags_for_box(infos, hazard)
            answer = (f"The ego vehicle should {brake_stop} because of the "
                      f"{phrase} that is {pos_str}.")

    # scenario overrides (:1003-1031)
    role = str(hazard.get("role_name", ""))
    if scenario == "BlockedIntersection" and "scenario" in role \
            and box_distance(hazard) < 15:
        tags = tags_for_box(infos, hazard)
        answer = (f"The ego vehicle should slow down because of the {phrase} "
                  f"that is {pos_str} and is blocking the intersection.")
    if m.get("vehicle_hazard"):
        near_junc = (scene.ego_get("is_in_junction")
                     or (scene.ego_get("distance_to_junction") is not None
                         and float(scene.ego_get("distance_to_junction"))
                         < 10))
        if scenario == "CrossingBicycleFlow" \
                and str(hazard.get("base_type", "")) == "bicycle" \
                and near_junc:
            tags = tags_for_box(infos, hazard)
            answer = (f"The ego vehicle should slow down because of the "
                      f"{phrase} that is {pos_str} and is crossing the "
                      "intersection.")
        if scenario == "InterurbanActorFlow" \
                and scene.ego_get("is_in_junction"):
            tags = tags_for_box(infos, hazard)
            answer = (f"The ego vehicle should stop because of the {phrase} "
                      "that is on the oncoming lane and is crossing paths "
                      "with the ego vehicle.")
    return answer, tags


def _braking_lane_change_scenarios(scene: Scene, infos: Dict[str, Dict],
                                   answer: str, tags: List[str]
                                   ) -> Tuple[str, List[str]]:
    """control_brake with no hazard object: one-way bypass scenarios
    (:1033-1096)."""
    m = scene.current
    scenario = scene.scenario
    brake_or_stop = "stop" if float(m.get("speed", 0.0)) < 1 else "brake"

    def closest(cands):
        return min(cands, key=box_distance) if cands else None

    if scenario == "Accident":
        obj = closest([v for v in scene.vehicles_by_id.values()
                       if v.get("type_id")
                       == "vehicle.dodge.charger_police_2020"
                       and "scenario" in str(v.get("role_name", ""))])
        if obj is not None and box_distance(obj) < 40:
            return (f"The ego vehicle should {brake_or_stop} because it "
                    "must change the lane to bypass the accident.",
                    tags_for_box(infos, obj))
    elif scenario == "ConstructionObstacle":
        obj = closest([s for s in scene.static_objects
                       if s.get("class") == "static_trafficwarning"
                       or "trafficwarning" in str(s.get("type_id", ""))])
        if obj is not None and box_distance(obj) < 40:
            return (f"The ego vehicle should {brake_or_stop} because it "
                    "must change the lane to bypass the construction "
                    "warning.", tags_for_box(infos, obj))
    elif scenario == "HazardAtSideLane":
        bikes = [v for v in scene.vehicles_by_id.values()
                 if "scenario" in str(v.get("role_name", ""))
                 and str(v.get("base_type", "")) == "bicycle"]
        obj = closest(bikes)
        if obj is not None and box_distance(obj) < 40:
            return (f"The ego vehicle should {brake_or_stop} because it "
                    f"must change the lane to bypass the {len(bikes)} "
                    "bicycles.", tags_for_box(infos, obj))
    elif scenario == "ParkedObstacle":
        obj = closest([v for v in scene.vehicles_by_id.values()
                       if "scenario" in str(v.get("role_name", ""))])
        if obj is not None and box_distance(obj) < 40:
            return (f"The ego vehicle should {brake_or_stop} because it "
                    "must change the lane to bypass the parked vehicle.",
                    tags_for_box(infos, obj))
    return answer, tags


# ---------------------------------------------------------------------------
# What should the ego vehicle do based on the {actor}? (:1108-1228)
# ---------------------------------------------------------------------------

def actor_action_question(scene: Scene, actor: Optional[Dict],
                          actor_type: str,
                          tags: Sequence[str]) -> Dict:
    question = f"What should the ego vehicle do based on the {actor_type}?"
    ego_speed = float(scene.current.get("speed", 0.0))

    if actor is None:
        if actor_type == "stop sign":
            cleared = [s for s in scene.stop_signs
                       if box_distance(s) < 4 and not s.get("affects_ego")
                       and float(np.asarray(s.get("position", [0, 0]),
                                            float)[0]) > -2.6]
            if cleared:
                answer = ("The ego vehicle was affected by a stop sign, "
                          "which has already been cleared.")
            else:
                answer = f"There is no {actor_type} affecting the ego vehicle."
        else:
            answer = f"There is no {actor_type} affecting the ego vehicle."
        chain, layer = (2, 2) if actor_type == "traffic light" else (1, 1)
        return _entry(question, answer, chain, layer, "planning", tags)

    answer = f"The ego vehicle should follow the {actor_type}."
    red_str = ("slow down and stop at the " + actor_type
               if ego_speed > 5 else "remain stopped")
    green_str = "accelerate" if ego_speed < 5 else "maintain its speed"
    state = str(actor.get("state_str", actor.get("state", "")) or "")
    state = state.capitalize()
    dist = box_distance(actor)

    handled = False
    for d in (10, 15, 20, 40):
        if dist < d:
            leading = scene.ego_get(f"affects_ego_{d}")
            if leading:
                if actor_type == "traffic light":
                    if state == "Green":
                        answer = ("Based on the green traffic light the ego "
                                  f"vehicle can {green_str} and continue "
                                  "driving but should pay attention to the "
                                  "vehicle in front and adjust its speed "
                                  "accordingly.")
                    elif state == "Yellow":
                        answer = ("The ego vehicle should slow down and "
                                  "prepare to stop at the traffic light.")
                    elif state == "Red":
                        answer = (f"The ego vehicle should {red_str} and "
                                  "stay behind other vehicles that are "
                                  "standing at the red light.")
                    else:
                        answer = ("The ego vehicle should follow the "
                                  "traffic light.")
                else:
                    answer = (f"The ego vehicle should {red_str} and stay "
                              "behind other vehicles that are standing at "
                              "the stop sign.")
            else:
                if actor_type == "traffic light":
                    if state == "Green":
                        answer = (f"The ego vehicle can {green_str} and "
                                  "continue driving because the traffic "
                                  "light is green.")
                    elif state == "Yellow":
                        answer = ("The ego vehicle should slow down and "
                                  "prepare to stop at the traffic light.")
                    elif state == "Red":
                        answer = f"The ego vehicle should {red_str}."
                    else:
                        answer = ("The ego vehicle should follow the "
                                  "traffic light.")
                else:
                    if ego_speed < 0.1 and not actor.get("affects_ego") \
                            and dist < 3:
                        answer = ("The ego vehicle can accelerate and "
                                  "continue driving if the intersection is "
                                  "clear because it has already stopped at "
                                  "the stop sign.")
                    else:
                        answer = f"The ego vehicle should {red_str}."
            handled = True
            break
    if not handled:
        answer = f"The {actor_type} is too far away to affect the ego vehicle."

    chain, layer = (2, 2) if actor_type == "traffic light" else (1, 1)
    return _entry(question, answer, chain, layer, "planning", tags)


# ---------------------------------------------------------------------------
# Obstruction lane change + obstacle question (:1230-1476)
# ---------------------------------------------------------------------------

def obstruction_questions(scene: Scene, important_objects: List[str],
                          infos: Dict[str, Dict]) -> List[Dict]:
    m = scene.current
    scenario = scene.scenario
    tags: List[str] = []
    relevant_objects: List[Dict] = []
    relevant_obj: Optional[Dict] = None

    if "ConstructionObstacle" in scenario:
        relevant_objects = [
            s for s in scene.static_objects
            if (s.get("class") == "static_trafficwarning"
                or "trafficwarning" in str(s.get("type_id", "")))
            and box_distance(s) < 40
            and float(np.asarray(s.get("position", [0, 0]), float)[0]) > 0.6]
    elif "VehicleOpensDoorTwoWays" in scenario:
        speed = max(1e-6, float(m.get("speed", 0.0)))
        relevant_objects = [
            v for v in scene.vehicles_by_id.values()
            if "scenario" in str(v.get("role_name", ""))
            and v.get("next_action") is None
            and float(np.asarray(v.get("position", [0, 0]), float)[0]) > -0.2
            and (box_distance(v) < 10 or box_distance(v) / speed < 3)]
    elif "InvadingTurn" in scenario:
        relevant_objects = [
            s for s in scene.static_objects
            if "constructioncone" in str(s.get("type_id", ""))
            and float(np.asarray(s.get("position", [0, 0]), float)[0]) >= 1.5
            and box_distance(s) <= 40]
    elif scenario == "ParkingExit":
        if scene.ego_get("lane_type_str") == "Parking":
            relevant_objects = [
                v for v in scene.vehicles_by_id.values()
                if "scenario" in str(v.get("role_name", ""))
                and v.get("lane_type_str") == "Parking"
                and 0 < float(np.asarray(v.get("position", [0, 0]),
                                         float)[0]) < 20]

    multiple_cones = False
    if relevant_objects:
        relevant_objects.sort(key=box_distance)
        relevant_obj = relevant_objects[0]
        y = float(np.asarray(relevant_obj.get("position", [0, 0]), float)[1])
        if -2 <= y <= 2:
            pos_str = "to the front of the ego vehicle"
        elif y > 2:
            pos_str = "to the front right of the ego vehicle"
        else:
            pos_str = "to the front left of the ego vehicle"

        if "ConstructionObstacle" in scenario:
            important_objects.append(f"the construction warning {pos_str}")
            category, visual = "Traffic element", "construction warning"
        elif "InvadingTurn" in scenario:
            multiple_cones = len(relevant_objects) > 1
            plural = "s" if multiple_cones else ""
            important_objects.append(
                f"the construction cone{plural} {pos_str}")
            category, visual = "Traffic element", "construction cone"
        else:  # VehicleOpensDoorTwoWays / ParkingExit
            color = vehicle_color(relevant_obj)
            category, visual = "Vehicle", f"{color}vehicle"
            if "VehicleOpensDoorTwoWays" in scenario:
                important_objects.append(
                    f"the {color}vehicle with the open doors {pos_str}")
            else:
                important_objects.append(
                    f"the {color}vehicle, parking {pos_str}")
        if scenario in ("ConstructionObstacle", "ConstructionObstacleTwoWays",
                        "InvadingTurn", "ParkingExit",
                        "VehicleOpensDoorTwoWays"):
            tags = [register_key_object(infos, category, visual,
                                        relevant_obj)]

    question = ("Does the ego vehicle need to change lanes or deviate from "
                "the lane center due to an upcoming obstruction?")
    answer = "No, the ego vehicle can stay on its current lane."
    question2 = "Is there an obstacle on the current road?"
    answer2 = "No, there is no obstacle on the current route."

    if scenario in OBSTACLE_NOUNS:
        obstacle = OBSTACLE_NOUNS[scenario]
        changed_route = bool(m.get("changed_route"))
        if "HazardAtSideLane" in scenario:
            relevant_objects = [
                v for v in scene.vehicles_by_id.values()
                if str(v.get("base_type", "")) == "bicycle"
                and should_consider_vehicle(v) and box_distance(v) < 40]
            if len(relevant_objects) == 1:
                obstacle = "bicycle"
        elif scenario not in ("VehicleOpensDoorTwoWays",
                              "ConstructionObstacle",
                              "ConstructionObstacleTwoWays", "InvadingTurn"):
            relevant_objects = [
                v for v in scene.vehicles_by_id.values()
                if "scenario" in str(v.get("role_name", ""))
                and should_consider_vehicle(v)
                and float(v.get("speed", 0.0)) == 0.0
                and box_distance(v) < 40]
        relevant_objects.sort(key=box_distance)

        if relevant_objects:
            if "Accident" in scenario:
                tags = [k for k, v in infos.items()
                        if "police" in v["Visual_description"]]
            elif "HazardAtSideLane" in scenario:
                tags = [k for k, v in infos.items()
                        if "bicycle" in v["Visual_description"]]
            elif "ParkedObstacle" in scenario \
                    or "VehicleOpensDoorTwoWays" in scenario:
                tags = tags_for_box(infos, relevant_objects[0])

            if changed_route:
                if scenario == "InvadingTurn":
                    answer = ("The ego vehicle has already shifted to the "
                              f"side to avoid {obstacle}.")
                else:
                    lateral = _lateral_offset_from_route(m)
                    changing = ("has already changed"
                                if lateral > 3.5 / 2.0 else "is changing")
                    answer = (f"The ego vehicle {changing} to another lane "
                              f"to circumvent the {obstacle}.")
            else:
                if scenario in ("Accident", "ConstructionObstacle",
                                "HazardAtSideLane", "ParkedObstacle"):
                    lane_change = int(scene.ego_get("lane_change", 0) or 0)
                    side = {1: "the right lane", 2: "the left lane",
                            3: "either side"}.get(lane_change)
                    if side:
                        answer = (f"The ego vehicle must change to {side} "
                                  f"to circumvent the {obstacle}.")
                    answer2 = _obstacle_answer(obstacle)
                elif scenario == "InvadingTurn":
                    answer = ("The ego vehicle must shift slightly to the "
                              f"right side to avoid {obstacle}.")
                    answer2 = ("Yes, there might be invading vehicles from "
                               "the opposite lane on the current road.")
                else:  # *TwoWays
                    answer = ("The ego vehicle must change to the opposite "
                              f"lane to circumvent the {obstacle}.")
                    answer2 = _obstacle_answer(obstacle)

        if changed_route \
                and answer == "No, the ego vehicle can stay on its current lane." \
                and scenario != "ParkingExit":
            answer = ("The ego vehicle must change back to the original "
                      "lane after passing the obstruction.")
    elif scenario == "ParkingExit":
        if scene.ego_get("lane_type_str") == "Parking":
            answer = ("The ego vehicle must change to the left to exit "
                      "the parking lot.")

    return [_entry(question, answer, 3, 8, "planning", tags),
            _entry(question2, answer2, 3, 9, "perception", tags)]


def _lateral_offset_from_route(m: Dict) -> float:
    route = m.get("route_original") or []
    if len(route) < 2:
        return 0.0
    start = np.asarray(route[0], float)[:2]
    end = np.asarray(route[1], float)[:2]
    vec = end - start
    norm = np.linalg.norm(vec)
    if norm < 1e-6:
        return float(np.linalg.norm(start))
    proj = abs(float(np.dot(vec, start)) / norm)
    d = float(np.linalg.norm(start))
    return float(np.sqrt(max(d * d - proj * proj, 0.0)))


def _obstacle_answer(obstacle: str) -> str:
    art = "an" if obstacle[:1] in "aeiou" else "a"
    phrase = f"{art} {obstacle}"
    verb = "are" if obstacle.startswith("two") else "is"
    return f"Yes, there {verb} {phrase} on the current road."


# ---------------------------------------------------------------------------
# Speed limit (:733-756)
# ---------------------------------------------------------------------------

def speed_limit_question(scene: Scene) -> Dict:
    sl = int(float(scene.current.get("speed_limit", 30.0 / 3.6)) * 3.6)
    return _entry("What is the current speed limit?",
                  f"The current speed limit is {sl} km/h.",
                  3, 7, "perception", [])


def ego_questions(scene: Scene, flags: HighwayFlags,
                  important_objects: List[str], infos: Dict[str, Dict],
                  tl_info: Optional[Dict], ss_info: Optional[Dict],
                  tl_tags: Sequence[str],
                  ss_tags: Sequence[str]) -> List[Dict]:
    out = obstruction_questions(scene, important_objects, infos)
    out.append(braking_question(scene, infos, tl_info, ss_info))
    out.append(actor_action_question(scene, tl_info, "traffic light",
                                     tl_tags))
    out.append(actor_action_question(scene, ss_info, "stop sign", ss_tags))
    out.append(speed_limit_question(scene))
    return out

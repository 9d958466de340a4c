"""Route-XML tooling: split long leaderboard routes into per-scenario
segments and balance the scenario-type distribution by upsampling.

Copy of `simlingo_tpu/labels/route_tools.py`.

Behavioral counterparts of the reference's
`dataset_generation/split_route_files.py` (907 LoC, route segmentation with
per-scenario completion distances) and
`dataset_generation/balance_scenarios.py` (357 LoC, upsampling with weather
and parameter jitter). Those scripts require a live CARLA server for map
queries (GlobalRoutePlanner interpolation, junction flags, lane-change
permissions); here that dependency is injected as a small ``RouteMap``
adapter so the tools run against live CARLA when present, the repo's test
stubs, or a pure-geometry fallback (straight-line 1 m interpolation, no
junctions) when no map backend is available.

CLI:
    python -m simlingo_tpu_torch.labels.route_tools split --path-in routes.xml \
        --save-path data/training --max-scenarios 1
    python -m simlingo_tpu_torch.labels.route_tools balance --path-in data/routes \
        --save-path data/routes_balanced --num-samples 150
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Weather randomization (reference split_route_files.py:75-99 /
# balance_scenarios.py get_random_weather_values)
# --------------------------------------------------------------------------

WEATHER_PARAMS = [
    "route_percentage", "cloudiness", "precipitation",
    "precipitation_deposits", "wetness", "wind_intensity",
    "sun_azimuth_angle", "sun_altitude_angle", "fog_density",
]

WEATHER_RANGES_EASY = {
    "cloudiness": [0.0, 2.0, 5.0, 10.0, 15.0, 20.0],
    "precipitation": [0.0, 2.0, 4.0, 6.0],
    "precipitation_deposits": [0.0, 4.0, 8.0],
    "wetness": [0.0, 2.0, 4.0, 6.0, 8.0, 10.0],
    "wind_intensity": [5.0, 10.0],
    "sun_azimuth_angle": [0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 270.0,
                          315.0, 360.0],
    "sun_altitude_angle": [10.0, 15.0, 20.0, 30.0, 45.0, 60.0, 70.0, 80.0,
                           90.0],
    "fog_density": [0.0, 0.0, 1.0, 1.0, 2.0],
}

WEATHER_RANGES_FULL = {
    "cloudiness": [0.0, 2.0, 5.0, 10.0, 15.0, 20.0, 40.0, 50.0, 60.0, 80.0,
                   100.0],
    "precipitation": [0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 15.0, 20.0, 30.0, 40.0,
                      50.0, 60.0, 80.0, 100.0],
    "precipitation_deposits": [0.0, 4.0, 8.0, 12.0, 16.0, 20.0, 30.0, 40.0,
                               50.0, 60.0, 80.0, 100.0],
    "wetness": [0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 20.0, 40.0, 60.0, 80.0,
                100.0],
    "wind_intensity": [5.0, 10.0, 25.0, 30.0, 50.0, 60.0, 80.0, 100.0],
    "sun_azimuth_angle": [0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 270.0,
                          315.0, 360.0],
    "sun_altitude_angle": [-90.0, -45.0, -30.0, -10.0, -15.0, 5.0, 0.0, 5.0,
                           10.0, 15.0, 20.0, 30.0, 45.0, 60.0, 70.0, 80.0,
                           90.0],
    "fog_density": [0.0, 0.0, 1.0, 1.0, 2.0, 3.0, 4.0, 6.0, 7.0, 8.0, 10.0,
                    15.0, 20.0, 40.0, 70.0, 100.0],
}


def random_weather(rng: random.Random, easy: bool = False
                   ) -> Tuple[List[float], List[float]]:
    """(begin, end) weather values in WEATHER_PARAMS order; route_percentage
    is pinned to 0/100 like the reference."""
    ranges = WEATHER_RANGES_EASY if easy else WEATHER_RANGES_FULL
    begin, end = [0.0], [100.0]
    for param in WEATHER_PARAMS[1:]:
        begin.append(rng.choice(ranges[param]))
        end.append(rng.choice(ranges[param]))
    return begin, end


# --------------------------------------------------------------------------
# Map adapters
# --------------------------------------------------------------------------

class RouteMap:
    """Map queries split_routes needs. Subclass for live CARLA or stubs.

    Commands are RoadOption names ('LANEFOLLOW', 'CHANGELANELEFT',
    'CHANGELANERIGHT', ...); lane_change returns one of 'NONE', 'Left',
    'Right', 'Both'.
    """

    def trace_route(self, a: Sequence[float], b: Sequence[float]
                    ) -> List[Tuple[List[float], str]]:
        raise NotImplementedError

    def is_junction(self, p: Sequence[float]) -> bool:
        return False

    def junction_has_traffic_lights(self, p: Sequence[float]) -> bool:
        return False

    def lane_change(self, p: Sequence[float]) -> str:
        return "Both"

    def same_dir_lane_points(self, p: Sequence[float]) -> List[List[float]]:
        return [list(p)]


class StraightLineMap(RouteMap):
    """Pure-geometry fallback: linear interpolation at `resolution` metres,
    no junctions. Enough for route segmentation over pre-interpolated route
    files (which leaderboard training XMLs already are)."""

    def __init__(self, resolution: float = 1.0):
        self.resolution = resolution

    def trace_route(self, a, b):
        a = np.asarray(a, float)
        b = np.asarray(b, float)
        dist = float(np.linalg.norm(b - a))
        n = max(int(dist / self.resolution), 1)
        ts = np.linspace(0.0, 1.0, n + 1)[1:]
        return [((a + t * (b - a)).tolist(), "LANEFOLLOW") for t in ts]


class CarlaRouteMap(RouteMap):
    """Adapter over a live (or stubbed) carla world + map +
    GlobalRoutePlanner, mirroring the reference's queries
    (split_route_files.py:103-121, :200, :695-703)."""

    def __init__(self, world, carla_map, planner):
        import carla  # noqa: F401 -- provided by the environment or stubs
        self._carla = __import__("carla")
        self.world = world
        self.map = carla_map
        self.planner = planner

    def _loc(self, p):
        return self._carla.Location(x=float(p[0]), y=float(p[1]),
                                    z=float(p[2]))

    def _wp(self, p):
        return self.map.get_waypoint(self._loc(p))

    def trace_route(self, a, b):
        trace = self.planner.trace_route(self._loc(a), self._loc(b))
        out = []
        for wp, cmd in trace:
            loc = wp.transform.location
            out.append(([loc.x, loc.y, loc.z], getattr(cmd, "name",
                                                       str(cmd))))
        return out

    def is_junction(self, p):
        return bool(self._wp(p).is_junction)

    def junction_has_traffic_lights(self, p):
        wp = self._wp(p)
        if not wp.is_junction:
            return False
        lights = self.world.get_traffic_lights_in_junction(wp.junction_id)
        return len(lights) > 0

    def lane_change(self, p):
        return getattr(self._wp(p).lane_change, "name",
                       str(self._wp(p).lane_change))


# --------------------------------------------------------------------------
# Route parsing + trace construction (reference Route class :195-290)
# --------------------------------------------------------------------------

@dataclass
class ParsedRoute:
    town: str
    waypoints: np.ndarray                    # [N, 3]
    scenarios: List[ET.Element]
    trigger_points: np.ndarray               # [S, 3]
    weather_begin: List[float]
    weather_end: List[float]
    trace: np.ndarray = field(default=None)  # [T, 3]
    trace_type: np.ndarray = field(default=None)   # 'waypoint'|'trace'|'scenario'
    trace_elem: List[Optional[ET.Element]] = field(default=None)
    trace_cmds: List[str] = field(default=None)
    is_junction: np.ndarray = field(default=None)

    def build_trace(self, rmap: RouteMap) -> "ParsedRoute":
        trace, ttype, telem, tcmds = [], [], [], []
        for i in range(len(self.waypoints) - 1):
            p, p_next = self.waypoints[i], self.waypoints[i + 1]
            interp = rmap.trace_route(p, p_next)
            trace.append(list(p))
            ttype.append("waypoint")
            telem.append(None)
            tcmds.append("LANEFOLLOW")
            for xyz, cmd in interp:
                trace.append(xyz)
                ttype.append("trace")
                telem.append(None)
                tcmds.append(cmd)
        trace.append(list(self.waypoints[-1]))
        ttype.append("waypoint")
        telem.append(None)
        tcmds.append("LANEFOLLOW")

        self.trace = np.asarray(trace, float)
        self.trace_type = np.asarray(ttype)
        self.trace_elem = telem
        self.trace_cmds = tcmds

        # splice each scenario trigger into the trace at its nearest
        # non-waypoint trace index (reference sort_scenarios_in :276-290)
        for scen, loc in zip(self.scenarios, self.trigger_points):
            diff = np.linalg.norm(self.trace - loc[None], axis=1)
            diff[self.trace_type == "waypoint"] = 1e9
            i = int(np.argmin(diff))
            self.trace = np.concatenate([self.trace[:i], loc[None],
                                         self.trace[i:]])
            self.trace_type = np.concatenate([self.trace_type[:i],
                                              ["scenario"],
                                              self.trace_type[i:]])
            self.trace_elem = self.trace_elem[:i] + [scen] \
                + self.trace_elem[i:]
            self.trace_cmds = self.trace_cmds[:i] + ["LANEFOLLOW"] \
                + self.trace_cmds[i:]
        self.is_junction = np.array([rmap.is_junction(p)
                                     for p in self.trace])
        return self


def parse_route_file(path: str) -> List[ParsedRoute]:
    routes = []
    tree = ET.parse(path)
    for route_tree in tree.iter("route"):
        weathers = []
        welem = route_tree.find("weathers")
        if welem is not None:
            for weather in welem.iter("weather"):
                weathers.append([float(weather.attrib.get(p, 0.0))
                                 for p in WEATHER_PARAMS])
        if len(weathers) < 2:
            weathers = [[0.0] * len(WEATHER_PARAMS),
                        [100.0] + [0.0] * (len(WEATHER_PARAMS) - 1)]
        wps = [[float(p.attrib["x"]), float(p.attrib["y"]),
                float(p.attrib.get("z", 0.0))]
               for p in route_tree.find("waypoints").iter("position")]
        scens, trigs = [], []
        selem = route_tree.find("scenarios")
        if selem is not None:
            for scen in selem.iter("scenario"):
                tp = scen.find("trigger_point")
                trigs.append([float(tp.attrib["x"]), float(tp.attrib["y"]),
                              float(tp.attrib.get("z", 0.0))])
                scens.append(scen)
        routes.append(ParsedRoute(
            town=route_tree.attrib.get("town", ""),
            waypoints=np.asarray(wps, float),
            scenarios=scens,
            trigger_points=(np.asarray(trigs, float) if trigs
                            else np.zeros((0, 3))),
            weather_begin=weathers[0], weather_end=weathers[1]))
    return routes


# --------------------------------------------------------------------------
# Per-scenario completion distances (reference :329-349, :417-620)
# --------------------------------------------------------------------------

# metres the route must continue past the trigger so the scenario can
# complete (reference distance_after table :417-423)
DISTANCE_AFTER = {
    "Accident": 86, "AccidentTwoWays": 86, "BlockedIntersection": 20,
    "ConstructionObstacle": 70, "ConstructionObstacleTwoWays": 70,
    "ControlLoss": 130, "CrossingBicycleFlow": 25,
    "DynamicObjectCrossing": 70, "EnterActorFlow": 110,
    "EnterActorFlowV2": 110, "HardBreakRoute": 65, "HazardAtSideLane": 150,
    "HazardAtSideLaneTwoWays": 150, "HighwayCutIn": 200, "HighwayExit": 30,
    "InterurbanActorFlow": 30, "InterurbanAdvancedActorFlow": 50,
    "InvadingTurn": 50, "MergerIntoSlowTraffic": 250,
    "MergerIntoSlowTrafficV2": 250, "NonSignalizedJunctionLeftTurn": 30,
    "NonSignalizedJunctionRightTurn": 30,
    "OppositeVehicleRunningRedLight": 30,
    "OppositeVehicleTakingPriority": 30, "ParkedObstacle": 70,
    "ParkedObstacleTwoWays": 70, "ParkingCrossingPedestrian": 60,
    "ParkingCutIn": 85, "ParkingExit": 50, "PedestrianCrossing": 30,
    "PriorityAtJunction": 30, "SignalizedJunctionLeftTurn": 30,
    "SignalizedJunctionRightTurn": 30, "StaticCutIn": 80,
    "VehicleOpensDoorTwoWays": 40, "VehicleTurningRoute": 70,
    "VehicleTurningRoutePedestrian": 70, "YieldToEmergencyVehicle": 260,
}

# scenarios whose completion distance walks the route to the end of the
# next junction (reference :572-618 elif chain)
_JUNCTION_END_SCENARIOS = {
    "CrossingBicycleFlow", "HighwayExit", "NonSignalizedJunctionLeftTurn",
    "NonSignalizedJunctionRightTurn", "OppositeVehicleTakingPriority",
    "PedestrianCrossing", "PriorityAtJunction",
    "SignalizedJunctionLeftTurn", "SignalizedJunctionRightTurn",
    "VehicleTurningRoute", "VehicleTurningRoutePedestrian",
    "InterurbanActorFlow", "InterurbanAdvancedActorFlow",
    "BlockedIntersection",
}

# scenarios whose completion distance comes from a <distance> (or related)
# parameter on the scenario element: type -> (param, default)
_PARAM_SCENARIOS = {
    "Accident": ("distance", 120), "AccidentTwoWays": ("distance", 120),
    "ParkedObstacle": ("distance", 120),
    "ParkedObstacleTwoWays": ("distance", 120),
    "ConstructionObstacle": ("distance", 100),
    "ConstructionObstacleTwoWays": ("distance", 100),
    "InvadingTurn": ("distance", 100), "StaticCutIn": ("distance", 100),
    "VehicleOpensDoorTwoWays": ("distance", 50),
    "ParkingCrossingPedestrian": ("distance", 12),
    "DynamicObjectCrossing": ("distance", 12),
    "YieldToEmergencyVehicle": ("distance", 140),
}


def preceding_distance(scenario_type: str) -> float:
    """Approach run-up before the trigger (reference :329-349)."""
    return 50.0 if scenario_type in ("HardBreakRoute", "HighwayExit") \
        else 20.0


def _value_param(elem: ET.Element, name: str, default: float) -> float:
    child = elem.find(name)
    return default if child is None else float(child.get("value"))


def _dist_to_junction_end(route: ParsedRoute, idx: int, rmap: RouteMap,
                          need_lights: bool = False) -> float:
    """Route metres from idx to the far side of the next junction (+25 m
    margin). With need_lights, to the first junction point whose junction
    has traffic lights (reference :434-466)."""
    end = idx
    seen_junction = False
    while end < len(route.trace) - 1:
        if need_lights:
            if route.is_junction[end] and rmap.junction_has_traffic_lights(
                    route.trace[end]):
                break
        else:
            if route.is_junction[end]:
                seen_junction = True
            elif seen_junction:
                break
        end += 1
    seg = np.diff(route.trace[idx:end, :2], axis=0)
    return float(np.linalg.norm(seg, axis=1).sum()) + 25.0


def _dist_to_lane_change(route: ParsedRoute, idx: int) -> float:
    i = idx
    while i < len(route.trace) - 1 and route.trace_cmds[i] not in (
            "CHANGELANELEFT", "CHANGELANERIGHT"):
        i += 1
    seg = np.diff(route.trace[idx:i, :2], axis=0)
    return float(np.linalg.norm(seg, axis=1).sum())


def _dist_until_overlap(route: ParsedRoute, idx: int, rmap: RouteMap,
                        max_distance: float, use_same_dir: bool) -> float:
    """Route metres until the ego route merges with the scenario's actor
    flow (reference get_distance_between_overlapping_routes{,_v2})."""
    elem = route.trace_elem[idx]
    start, end = elem.find("start_actor_flow"), elem.find("end_actor_flow")
    if start is None or end is None:
        return 0.0
    a = [float(start.attrib["x"]), float(start.attrib["y"]),
         float(start.attrib.get("z", 0.0))]
    b = [float(end.attrib["x"]), float(end.attrib["y"]),
         float(end.attrib.get("z", 0.0))]
    sources = rmap.same_dir_lane_points(a) if use_same_dir else [a]
    sinks = rmap.same_dir_lane_points(b) if use_same_dir else [b]
    flow = []
    for s, t in zip(sources, sinks):
        flow.extend(xyz for xyz, _ in rmap.trace_route(s, t))
    flow = np.asarray(flow, float)
    i, current, minimum = idx, 100.0, 1e9
    while True:
        minimum = min(minimum, current)
        if i >= len(route.trace) or current < max_distance \
                or minimum + 20.0 < current:
            break
        current = float(np.linalg.norm(route.trace[i][None] - flow,
                                       axis=1).min())
        i += 1
    seg = np.diff(route.trace[idx:i, :2], axis=0)
    return float(np.linalg.norm(seg, axis=1).sum())


def _dist_until_right_lane_change_possible(route: ParsedRoute, idx: int,
                                           rmap: RouteMap) -> float:
    i = idx
    while i < len(route.trace) - 1 and rmap.lane_change(
            route.trace[i]) not in ("Right", "Both"):
        i += 1
    seg = np.diff(route.trace[idx:i, :2], axis=0)
    return float(np.linalg.norm(seg, axis=1).sum())


def succeeding_distance(route: ParsedRoute, idx: int,
                        rmap: RouteMap) -> float:
    """Total route metres required after the trigger: the fixed
    DISTANCE_AFTER margin plus the scenario-specific dynamic part
    (reference get_succeeding_distance :556-620)."""
    elem = route.trace_elem[idx]
    typ = elem.get("type")
    extra = 0.0
    if typ in _PARAM_SCENARIOS:
        param, default = _PARAM_SCENARIOS[typ]
        extra = _value_param(elem, param, default)
    elif typ in ("HazardAtSideLane", "HazardAtSideLaneTwoWays"):
        extra = _value_param(elem, "distance", 100) \
            + _value_param(elem, "bicycle_drive_distance", 50)
    elif typ == "OppositeVehicleRunningRedLight":
        extra = _dist_to_junction_end(route, idx, rmap, need_lights=True)
    elif typ in _JUNCTION_END_SCENARIOS:
        extra = _dist_to_junction_end(route, idx, rmap)
    elif typ in ("EnterActorFlow", "EnterActorFlowV2"):
        extra = _dist_until_overlap(route, idx, rmap, 2.0,
                                    use_same_dir=True)
    elif typ in ("MergerIntoSlowTraffic", "MergerIntoSlowTrafficV2"):
        extra = _dist_until_overlap(route, idx, rmap, 1.5,
                                    use_same_dir=False)
    elif typ == "HighwayCutIn":
        extra = _dist_until_right_lane_change_possible(route, idx, rmap)
    return extra + DISTANCE_AFTER.get(typ, 50)


# --------------------------------------------------------------------------
# Segment extraction (reference get_previous_waypoints /
# get_succeeding_waypoints :351-380, :621-650)
# --------------------------------------------------------------------------

def _walk_back(route: ParsedRoute, first_idx: int) -> List[int]:
    min_dist = preceding_distance(route.trace_elem[first_idx].get("type"))
    trace = route.trace[:first_idx + 1, :2]
    diff = np.linalg.norm(np.diff(trace, axis=0), axis=1)
    dist_to_trigger = np.cumsum(diff[::-1])[::-1]
    picked: List[int] = []
    cooldown = 0
    for i in range(first_idx - 1, -1, -1):
        if route.trace_type[i] == "waypoint":
            picked.append(i)
        if dist_to_trigger[i] > min_dist:
            if route.is_junction[i]:
                cooldown = 20     # keep the start 20 m clear of junctions
            elif cooldown == 0:
                picked.append(i)
                break
            else:
                cooldown -= 1
    return picked[::-1]


def _walk_forward(route: ParsedRoute, last_idx: int,
                  rmap: RouteMap) -> List[int]:
    min_dist = succeeding_distance(route, last_idx, rmap)
    trace = route.trace[last_idx:, :2]
    diff = np.linalg.norm(np.diff(trace, axis=0), axis=1)
    dist_from_trigger = np.cumsum(diff)
    picked: List[int] = []
    cooldown = 0
    for i in range(last_idx + 1, len(route.trace)):
        if route.trace_type[i] == "waypoint":
            picked.append(i)
        if dist_from_trigger[i - last_idx - 1] > min_dist:
            if route.is_junction[i]:
                cooldown = 20
            elif cooldown == 0:
                picked.append(i)
                break
            else:
                cooldown -= 1
    return picked


def _write_route_elem(parent: ET.Element, route: ParsedRoute,
                      route_id: int, rng: random.Random,
                      randomize_weather: bool, easy_weather: bool
                      ) -> Tuple[ET.Element, ET.Element]:
    relem = ET.SubElement(parent, "route")
    relem.set("id", str(route_id))
    relem.set("town", route.town)
    weathers = ET.SubElement(relem, "weathers")
    begin = ET.SubElement(weathers, "weather")
    end = ET.SubElement(weathers, "weather")
    if randomize_weather:
        vb, ve = random_weather(rng, easy_weather)
    else:
        vb, ve = route.weather_begin, route.weather_end
    for name, b, e in zip(WEATHER_PARAMS, vb, ve):
        begin.set(name, "{:.1f}".format(b))
        end.set(name, "{:.1f}".format(e))
    return (ET.SubElement(relem, "waypoints"),
            ET.SubElement(relem, "scenarios"))


def split_routes(path_in: str, save_path: str,
                 rmap: Optional[RouteMap] = None,
                 max_scenarios: int = 1, routes_per_file: int = 1,
                 only_waypoints: bool = False,
                 randomize_weather: bool = True, easy_weather: bool = False,
                 exclude_scenarios: Sequence[str] = (),
                 seed: int = 1) -> Dict:
    """Split every route in `path_in` into segments of `max_scenarios`
    scenarios (0 = keep whole routes), with run-up before the first trigger
    and completion distance after the last. Writes numbered XMLs under
    `save_path`, plus per-scenario-type subfolders and a stats JSON.

    Returns {"files": n, "segments": [...], "lengths": [...]}.
    """
    rng = random.Random(seed)
    rmap = rmap or StraightLineMap()
    os.makedirs(save_path, exist_ok=True)
    routes = [r.build_trace(rmap) for r in parse_route_file(path_in)]

    n_file, in_file = 0, 0
    data = ET.Element("routes")
    segments: List[Dict] = []
    lengths: List[float] = []

    def flush():
        nonlocal n_file, in_file, data
        if in_file == 0:
            return
        ET.indent(ET.ElementTree(data))
        ET.ElementTree(data).write(
            os.path.join(save_path, f"{n_file}.xml"))
        n_file += 1
        in_file = 0
        data = ET.Element("routes")

    def emit(route: ParsedRoute, scen_idx: List[int]) -> None:
        nonlocal in_file
        wp_elem, sc_elem = _write_route_elem(
            data, route, in_file, rng, randomize_weather, easy_weather)
        if scen_idx:
            before = _walk_back(route, scen_idx[0])
            after = _walk_forward(route, scen_idx[-1], rmap)
            middle = [i for i in range(scen_idx[0], scen_idx[-1] + 1)
                      if route.trace_type[i] == "waypoint"]
            all_idx = before + middle + after
        else:
            all_idx = list(range(len(route.trace)))
        for i in all_idx:
            p = route.trace[i]
            pos = ET.SubElement(wp_elem, "position")
            pos.set("x", "{:.1f}".format(p[0]))
            pos.set("y", "{:.1f}".format(p[1]))
            pos.set("z", "{:.1f}".format(p[2]))
        if not only_waypoints:
            for i in scen_idx:
                sc_elem.append(route.trace_elem[i])
        if all_idx:
            seg = route.trace[all_idx, :2]
            length = float(np.linalg.norm(np.diff(seg, axis=0),
                                          axis=1).sum())
            lengths.append(length)
            segments.append({
                "file": n_file, "length_m": length,
                "scenarios": [route.trace_elem[i].get("type")
                              for i in scen_idx],
            })
        in_file += 1
        if in_file >= routes_per_file:
            flush()

    for route in routes:
        if max_scenarios == 0:
            emit(route, [])
            continue
        pending: List[int] = []
        for i, ttype in enumerate(route.trace_type):
            if ttype == "scenario" and route.trace_elem[i].get("type") \
                    not in exclude_scenarios:
                pending.append(i)
            if len(pending) == max_scenarios:
                emit(route, pending)
                pending = []
        if pending:
            emit(route, pending)
    flush()

    # per-scenario-type subfolders (reference :893-908) + stats
    if not only_waypoints:
        by_type: Dict[str, List[int]] = {}
        for seg in segments:
            for typ in seg["scenarios"]:
                by_type.setdefault(typ, []).append(seg["file"])
        for typ, files in by_type.items():
            tdir = os.path.join(save_path, typ)
            os.makedirs(tdir, exist_ok=True)
            for f in sorted(set(files)):
                src = os.path.join(save_path, f"{f}.xml")
                if os.path.exists(src):
                    import shutil
                    shutil.copy(src, os.path.join(tdir, f"{f}.xml"))
    stats = {
        "files": n_file,
        "median_length_m": float(np.median(lengths)) if lengths else 0.0,
        "mean_length_per_scenario": {
            typ: float(np.mean([s["length_m"] for s in segments
                                if typ in s["scenarios"]]))
            for s in segments for typ in s["scenarios"]},
    }
    with open(os.path.join(save_path,
                           "average_route_lengths_per_scenario.json"),
              "w") as fp:
        json.dump(stats["mean_length_per_scenario"], fp, indent=1)
    return {"files": n_file, "segments": segments, "lengths": lengths,
            **stats}


# --------------------------------------------------------------------------
# Balancing by upsampling (reference balance_scenarios.py)
# --------------------------------------------------------------------------

def count_scenarios(paths: Sequence[str]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for path in paths:
        try:
            tree = ET.parse(path)
        except ET.ParseError:
            continue
        for route in tree.getroot().iter("route"):
            scens = route.find("scenarios")
            found = [s.attrib["type"] for s in scens.iter("scenario")] \
                if scens is not None else []
            for name in (found or ["None"]):
                counts[name] = counts.get(name, 0) + 1
    return counts


def balance_scenarios(path_in: str, save_path: str, num_samples: int = 150,
                      routes_per_file: int = 40, easy_weather: bool = False,
                      seed: int = 1,
                      downsample_types: Sequence[str] = ("ControlLoss",
                                                         "HardBreakRoute"),
                      downsample_keep: float = 0.01,
                      max_tries_factor: int = 30000) -> Dict:
    """Upsample route files so each scenario type reaches ~`num_samples`
    instances. Upsampled copies get fresh random weather and +-10% jitter on
    the scenario <distance> parameter; routes containing `downsample_types`
    are kept with probability `downsample_keep` (reference
    balance_scenarios.py main loop). Returns {"before": .., "after": ..}.
    """
    rng = random.Random(seed)
    os.makedirs(save_path, exist_ok=True)
    all_xml = sorted(glob.glob(os.path.join(path_in, "**", "*.xml"),
                               recursive=True))

    routes_by_type: Dict[str, List[str]] = {}
    for path in all_xml:
        for name in count_scenarios([path]):
            routes_by_type.setdefault(name, []).append(path)
    before = count_scenarios(all_xml)

    upsampled: Dict[str, int] = {}
    usage: Dict[str, int] = {}
    n_file = 0
    out_root = ET.Element("routes")
    out_count = 0

    def flush():
        nonlocal n_file, out_root, out_count
        if out_count == 0:
            return
        n_file += 1
        ET.indent(ET.ElementTree(out_root))
        ET.ElementTree(out_root).write(
            os.path.join(save_path, f"{n_file}.xml"))
        out_root = ET.Element("routes")
        out_count = 0

    # rarest types first so they get first pick of the shared routes
    for name, routes in sorted(routes_by_type.items(),
                               key=lambda kv: len(kv[1])):
        if name == "None":
            for path in rng.choices(routes, k=num_samples):
                tree = ET.parse(path)
                n_file += 1
                tree.write(os.path.join(save_path, f"{n_file}.xml"))
            continue
        tries = 0
        while upsampled.get(name, 0) < num_samples \
                and tries < max_tries_factor * len(routes):
            tries += 1
            path = rng.choice(routes)
            if usage.get(path, 0) >= num_samples:
                continue
            tree = ET.parse(path)
            for route in tree.getroot().iter("route"):
                scens = route.find("scenarios")
                if scens is None:
                    continue
                types = [s.attrib["type"] for s in scens.iter("scenario")]
                if any(t in downsample_types for t in types) \
                        and rng.random() > downsample_keep:
                    continue
                if name not in types:
                    continue
                for t in types:
                    upsampled[t] = upsampled.get(t, 0) + 1
                route.set("id", str(out_count))
                for scen in scens.iter("scenario"):
                    dist = scen.find("distance")
                    if dist is not None:
                        v = float(dist.attrib["value"])
                        dist.set("value", "{:.1f}".format(
                            v * (1.0 + rng.uniform(-0.1, 0.1))))
                welem = route.find("weathers")
                if welem is not None:
                    ws = welem.findall("weather")
                    if len(ws) >= 2:
                        vb, ve = random_weather(rng, easy_weather)
                        for pname, b, e in zip(WEATHER_PARAMS, vb, ve):
                            ws[0].set(pname, "{:.1f}".format(b))
                            ws[1].set(pname, "{:.1f}".format(e))
                out_root.append(route)
                out_count += 1
                if out_count >= routes_per_file:
                    usage[path] = usage.get(path, 0) + 1
                    flush()
    flush()

    after = count_scenarios(sorted(glob.glob(
        os.path.join(save_path, "**", "*.xml"), recursive=True)))
    report = {"before": before, "after": after, "files": n_file}
    with open(os.path.join(save_path, "balance_report.json"), "w") as fp:
        json.dump(report, fp, indent=1)
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("split")
    sp.add_argument("--path-in", required=True)
    sp.add_argument("--save-path", required=True)
    sp.add_argument("--max-scenarios", type=int, default=1)
    sp.add_argument("--routes-per-file", type=int, default=1)
    sp.add_argument("--only-waypoints", action="store_true")
    sp.add_argument("--easy-weather", action="store_true")
    sp.add_argument("--seed", type=int, default=1)
    bp = sub.add_parser("balance")
    bp.add_argument("--path-in", required=True)
    bp.add_argument("--save-path", required=True)
    bp.add_argument("--num-samples", type=int, default=150)
    bp.add_argument("--routes-per-file", type=int, default=40)
    bp.add_argument("--easy-weather", action="store_true")
    bp.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if args.cmd == "split":
        rmap: RouteMap = StraightLineMap()
        try:  # live CARLA if available (reference connects on :103)
            import carla
            from agents.navigation.global_route_planner import \
                GlobalRoutePlanner
            client = carla.Client("localhost", 2000)
            client.set_timeout(240)
            world = client.get_world()
            rmap = CarlaRouteMap(world, world.get_map(),
                                 GlobalRoutePlanner(world.get_map(), 1.0))
        except Exception:
            pass
        out = split_routes(args.path_in, args.save_path, rmap,
                           max_scenarios=args.max_scenarios,
                           routes_per_file=args.routes_per_file,
                           only_waypoints=args.only_waypoints,
                           easy_weather=args.easy_weather, seed=args.seed)
        print(json.dumps({"files": out["files"],
                          "median_length_m": out["median_length_m"]}))
    else:
        report = balance_scenarios(
            args.path_in, args.save_path, num_samples=args.num_samples,
            routes_per_file=args.routes_per_file,
            easy_weather=args.easy_weather, seed=args.seed)
        print(json.dumps({"files": report["files"]}))


if __name__ == "__main__":
    main()

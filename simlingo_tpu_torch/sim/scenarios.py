"""Bench2Drive scenario inventory on microsim primitives.

Copy of `simlingo_tpu/sim/scenarios.py`.

Each builder spawns the scenario's actors into a SimWorld along the ego
route and returns the `active_scenario_record` dict the expert's scenario
manager consumes (expert/scenarios.py contract -- the same records the
CARLA plugin extracts from the patched leaderboard's
CarlaDataProvider.active_scenarios, reference
leaderboard_autopilot/leaderboard/scenarios/route_scenario.py).

Reference scenario definitions:
  Bench2Drive/scenario_runner/srunner/scenarios/*.py
  (accident.py construction_obstacle.py parked_obstacle.py
   vehicle_opens_door.py hazard_at_side_lane.py invading_turn.py
   yield_to_emergency_vehicle.py blocked_intersection.py
   pedestrian_crossing.py ...)
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from simlingo_tpu_torch.sim.actors import Actor, Vehicle, Walker, static_prop
from simlingo_tpu_torch.sim.map import Lane
from simlingo_tpu_torch.sim.world import SimWorld


def _route_pose(route: np.ndarray, s: float) -> Tuple[np.ndarray, float]:
    """(position, yaw) at arc length s along a sparse route polyline."""
    route = np.asarray(route, float)[:, :2]
    seg = np.linalg.norm(np.diff(route, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    s = min(max(s, 0.0), cum[-1])
    i = min(int(np.searchsorted(cum, s)), len(route) - 2)
    t = route[i + 1] - route[i]
    yaw = math.atan2(t[1], t[0])
    frac = (s - cum[i]) / max(seg[i] if i < len(seg) else 1.0, 1e-9)
    return route[i] + frac * t, yaw


def _left_normal(yaw: float) -> np.ndarray:
    return np.array([-math.sin(yaw), math.cos(yaw)])


def _actor_rec(actor: Actor) -> Dict:
    return {"position": [float(actor.position[0]), float(actor.position[1])],
            "extent": [float(actor.extent[0]), float(actor.extent[1])],
            "yaw": float(actor.yaw), "id": actor.actor_id,
            "type_id": actor.type_id}


class ScenarioBuilder:
    """Places one named scenario at arc length s along the ego route."""

    def __init__(self, world: SimWorld, route: np.ndarray):
        self.world = world
        self.route = np.asarray(route, float)[:, :2]

    def _bypass_direction(self, at_s: float) -> str:
        """Side to overtake a blocker on: prefer a same-direction
        neighbor lane (the reference's multi-lane Accident/Construction
        re-plan through available lanes); fall back to the oncoming side
        (TwoWays geometry) when the road has one lane per direction."""
        lane = self.world.map.closest_lane(_route_pose(self.route,
                                                       at_s)[0])
        right = self.world.map.neighbor(lane, "right")
        if right is not None and right.lane_type == "driving":
            return "right"
        return "left"

    def build(self, name: str, at_s: float, **kw) -> Optional[Dict]:
        fn = getattr(self, "_" + _snake(name), None)
        if fn is None:
            raise ValueError(f"unknown scenario type: {name}")
        rec = fn(at_s, **kw)
        if rec is not None:
            rec["type"] = name
        return rec

    # -- static blockages (accident.py / construction_obstacle.py /
    #    parked_obstacle.py + their TwoWays variants) ------------------------
    def _accident(self, at_s: float, two_ways: bool = False) -> Dict:
        pos, yaw = _route_pose(self.route, at_s)
        pos2, yaw2 = _route_pose(self.route, at_s + 9.0)
        w = self.world
        first = w.spawn(Vehicle(pos, yaw=yaw + 0.25, behavior="parked",
                                type_id="vehicle.tesla.model3",
                                color="180,20,20", role="scenario"))
        last = w.spawn(Vehicle(pos2, yaw=yaw2 - 0.2, behavior="parked",
                               type_id="vehicle.carlamotors.firetruck",
                               base_type="truck", extent=(4.2, 1.4),
                               color="200,30,30", role="scenario"))
        # warning cones along the roadside BEHIND/BESIDE the wreck on the
        # side OPPOSITE the overtake corridor (reference accident.py cone
        # placement funnels traffic toward the open side)
        direction = "left" if two_ways \
            else self._bypass_direction(at_s)
        cone_side = -1.4 if direction == "left" else 1.4
        for ds in (-6.0, 4.0, 14.0):
            p, y = _route_pose(self.route, at_s + ds)
            w.spawn(static_prop(p + _left_normal(y) * cone_side, yaw=y))
        return {"first_actor": _actor_rec(first),
                "last_actor": _actor_rec(last),
                "direction": direction}

    def _accident_two_ways(self, at_s: float) -> Dict:
        return self._accident(at_s, two_ways=True)

    def _construction_obstacle(self, at_s: float,
                              two_ways: bool = False) -> Dict:
        pos, yaw = _route_pose(self.route, at_s)
        w = self.world
        first = w.spawn(static_prop(
            pos, yaw=yaw, type_id="static.prop.trafficwarning",
            extent=(1.2, 1.0), role="scenario"))
        last_pos, last_yaw = _route_pose(self.route, at_s + 12.0)
        last = w.spawn(static_prop(last_pos, yaw=last_yaw,
                                   type_id="static.prop.trafficwarning",
                                   extent=(1.2, 1.0), role="scenario"))
        for ds in np.arange(2.0, 11.0, 2.0):
            p, y = _route_pose(self.route, at_s + ds)
            w.spawn(static_prop(p + _left_normal(y)
                                * (0.8 * math.sin(ds)), yaw=y))
        return {"first_actor": _actor_rec(first),
                "last_actor": _actor_rec(last),
                "direction": "left" if two_ways
                else self._bypass_direction(at_s)}

    def _construction_obstacle_two_ways(self, at_s: float) -> Dict:
        return self._construction_obstacle(at_s, two_ways=True)

    def _parked_obstacle(self, at_s: float,
                         two_ways: bool = False) -> Dict:
        pos, yaw = _route_pose(self.route, at_s)
        first = self.world.spawn(Vehicle(
            pos + _left_normal(yaw) * -0.9, yaw=yaw, behavior="parked",
            type_id="vehicle.audi.tt", color="60,60,160", role="scenario"))
        return {"first_actor": _actor_rec(first),
                "direction": "left" if two_ways
                else self._bypass_direction(at_s)}

    def _parked_obstacle_two_ways(self, at_s: float) -> Dict:
        return self._parked_obstacle(at_s, two_ways=True)

    def _vehicle_opens_door_two_ways(self, at_s: float) -> Dict:
        pos, yaw = _route_pose(self.route, at_s)
        first = self.world.spawn(Vehicle(
            pos + _left_normal(yaw) * -0.8, yaw=yaw, behavior="parked",
            type_id="vehicle.mercedes.coupe_2020",
            extent=(2.6, 1.6),           # widened: door open into the lane
            color="20,60,120", role="scenario"))
        return {"first_actor": _actor_rec(first), "direction": "left"}

    # -- moving hazards -------------------------------------------------------
    def _hazard_at_side_lane(self, at_s: float,
                             two_ways: bool = False) -> Dict:
        """Two slow bicycles at the lane edge ahead of the ego."""
        w = self.world
        lane = w.map.closest_lane(_route_pose(self.route, at_s)[0])
        bikes = []
        for ds in (0.0, 6.0):
            pos, yaw = _route_pose(self.route, at_s + ds)
            bikes.append(w.spawn(Vehicle(
                pos + _left_normal(yaw) * -1.2, yaw=yaw, speed=3.0,
                lane=lane, target_speed=3.0,
                type_id="vehicle.diamondback.century",
                base_type="bicycle", extent=(0.9, 0.4),
                color="20,160,60", role="scenario")))
        return {"first_actor": _actor_rec(bikes[0]),
                "last_actor": _actor_rec(bikes[1]), "direction": "left"}

    def _hazard_at_side_lane_two_ways(self, at_s: float) -> Dict:
        return self._hazard_at_side_lane(at_s, two_ways=True)

    def _invading_turn(self, at_s: float) -> Dict:
        """Cones on the oncoming side invading the ego lane in a bend."""
        w = self.world
        cones = []
        for ds in np.arange(0.0, 24.0, 4.0):
            pos, yaw = _route_pose(self.route, at_s + ds)
            cones.append(w.spawn(static_prop(
                pos + _left_normal(yaw) * 1.1, yaw=yaw,
                type_id="static.prop.constructioncone",
                role="scenario")))
        return {"first_actor": _actor_rec(cones[0]),
                "last_actor": _actor_rec(cones[-1]),
                "direction": "right", "offset": 0.8}

    def _yield_to_emergency_vehicle(self, at_s: float,
                                    behind: float = 35.0) -> Dict:
        """Ambulance approaching from behind on the ego lane
        (yield_to_emergency_vehicle.py spawns it ~50 m back and lets it
        close in; the ego must shift aside to let it pass)."""
        w = self.world
        anchor, _ = _route_pose(self.route, max(at_s, 0.0))
        lane = w.map.closest_lane(anchor)
        s_anchor, _ = lane.project(anchor)
        s_spawn = max(s_anchor - behind, 0.0)
        pos, yaw = lane.point_at_s(s_spawn), lane.yaw_at_s(s_spawn)
        emv = w.spawn(Vehicle(pos, yaw=yaw, speed=14.0, lane=lane,
                              target_speed=16.0,
                              type_id="vehicle.ford.ambulance",
                              base_type="van", extent=(3.2, 1.3),
                              color="240,240,240", role="scenario"))
        return {"first_actor": _actor_rec(emv), "direction": "right"}

    # -- junction / crossing ---------------------------------------------------
    def _blocked_intersection(self, at_s: float,
                              clear_after: float = 12.0) -> Dict:
        """A vehicle blocks the junction; it drives clear after the ego
        has waited (blocked_intersection.py: the blocker leaves on a
        timer once the ego arrives)."""
        pos, yaw = _route_pose(self.route, at_s)
        first = self.world.spawn(Vehicle(
            pos, yaw=yaw + math.pi / 2, behavior="parked",
            target_speed=6.0,
            type_id="vehicle.nissan.patrol", extent=(2.5, 1.1),
            color="40,40,40", role="scenario"))
        first.unblock_trigger_distance = 30.0
        first.unblock_delay = clear_after
        return {"first_actor": _actor_rec(first)}

    def _dynamic_object_crossing(self, at_s: float,
                                 trigger_distance: float = 18.0) -> Dict:
        """Pedestrian steps onto the road when the ego approaches
        (pedestrian_crossing.py / DynamicObjectCrossing)."""
        pos, yaw = _route_pose(self.route, at_s)
        n = _left_normal(yaw)
        start = pos + n * -5.0
        path = np.stack([pos + n * -2.0, pos + n * 4.0], 0)
        walker = self.world.spawn(Walker(
            start, path=path, trigger_distance=trigger_distance,
            role="scenario"))
        walker.yaw = yaw + math.pi / 2
        return {"first_actor": _actor_rec(walker)}

    def _opposite_vehicle_running_red_light(self, at_s: float,
                                            trigger_distance: float = 35.0
                                            ) -> Dict:
        """A crossing vehicle blows through its red as the ego enters the
        junction on green (opposite_vehicle_taking_priority.py): scripted
        straight-line crosser triggered by ego proximity."""
        pos, yaw = _route_pose(self.route, at_s)
        n = _left_normal(yaw)
        w = self.world
        runner = w.spawn(Vehicle(pos + n * -30.0, yaw=yaw + math.pi / 2,
                                 speed=0.0, target_speed=10.0,
                                 type_id="vehicle.dodge.charger_2020",
                                 color="30,30,30", role="scenario"))
        runner.behavior = "scripted"
        runner._trigger = ("dash", trigger_distance, 10.0)
        return {"first_actor": _actor_rec(runner)}

    def _signalized_junction_left_turn(self, at_s: float) -> Dict:
        """Oncoming through-traffic while the ego turns left on green
        (signalized_junction_left_turn.py): constant flow on the opposite
        lane that the ego's turn path crosses."""
        w = self.world
        lane_in = w.map.closest_lane(_route_pose(self.route, 0.0)[0])
        opp = w.map.lanes.get(lane_in.opposite)
        first = None
        if opp is not None:
            anchor, _ = _route_pose(self.route, at_s)
            s_a, _ = opp.project(anchor)
            for k in range(3):
                s = s_a - 25.0 - 28.0 * k
                v = w.spawn(Vehicle(opp.point_at_s(s),
                                    yaw=opp.yaw_at_s(s), speed=7.0,
                                    lane=opp, target_speed=7.0,
                                    type_id="vehicle.toyota.prius",
                                    color="160,160,170",
                                    role="scenario"))
                first = first or v
        return {"first_actor": _actor_rec(first)} if first else None

    def _highway_cut_in(self, at_s: float,
                        trigger_distance: float = 25.0) -> Dict:
        """A neighbor-lane vehicle merges into the ego lane just ahead
        (highway_cut_in.py)."""
        w = self.world
        ego_lane = w.map.closest_lane(_route_pose(self.route, 0.0)[0])
        side = (w.map.neighbor(ego_lane, "right")
                or w.map.neighbor(ego_lane, "left") or ego_lane)
        anchor, _ = _route_pose(self.route, at_s)
        s_a, _ = side.project(anchor)
        cutter = w.spawn(Vehicle(side.point_at_s(s_a),
                                 yaw=side.yaw_at_s(s_a), speed=6.0,
                                 lane=side, target_speed=6.0,
                                 type_id="vehicle.bmw.grandtourer",
                                 color="60,90,160", role="scenario"))
        cutter.cut_in_lane = ego_lane
        cutter.cut_in_trigger_distance = trigger_distance
        return {"first_actor": _actor_rec(cutter)}

    def _static_cut_in(self, at_s: float,
                       trigger_distance: float = 30.0) -> Dict:
        """A parked vehicle pulls out into the ego lane as the ego closes
        in (static_cut_in.py): parked at the lane edge, unblocks on
        proximity and merges to the lane center."""
        w = self.world
        ego_lane = w.map.closest_lane(_route_pose(self.route, 0.0)[0])
        pos, yaw = _route_pose(self.route, at_s)
        puller = w.spawn(Vehicle(pos + _left_normal(yaw) * -1.6, yaw=yaw,
                                 behavior="parked", target_speed=5.0,
                                 type_id="vehicle.ford.mustang",
                                 color="120,20,20", role="scenario"))
        puller.unblock_trigger_distance = trigger_distance
        puller.unblock_delay = 0.0
        puller.lane = ego_lane
        return {"first_actor": _actor_rec(puller)}

    def _parking_crossing_pedestrian(self, at_s: float,
                                     trigger_distance: float = 16.0
                                     ) -> Dict:
        """A pedestrian steps out from BETWEEN parked cars
        (parking_crossing_pedestrian.py): occluded until late, so the
        brake reaction is harder than the open crossing."""
        w = self.world
        n = None
        for ds in (-7.0, 0.0, 7.0):
            pos, yaw = _route_pose(self.route, at_s + ds)
            n = _left_normal(yaw)
            w.spawn(Vehicle(pos + n * -2.8, yaw=yaw, behavior="parked",
                            type_id="vehicle.seat.leon",
                            color="90,90,90", role="scenario"))
        pos, yaw = _route_pose(self.route, at_s + 3.5)
        n = _left_normal(yaw)
        start = pos + n * -2.8           # between the parked cars
        path = np.stack([pos + n * -1.2, pos + n * 4.0], 0)
        walker = w.spawn(Walker(start, path=path,
                                trigger_distance=trigger_distance,
                                role="scenario"))
        walker.yaw = yaw + math.pi / 2
        return {"first_actor": _actor_rec(walker)}

    # -- shared helpers for flow-based scenarios -------------------------------
    def _spawn_flow(self, lane: Lane, anchor_xy: np.ndarray, n: int = 4,
                    gap: float = 26.0, speed: float = 6.0,
                    lead: float = 20.0,
                    type_id: str = "vehicle.toyota.prius",
                    color: str = "160,160,170") -> Optional[Vehicle]:
        """`n` lane-following vehicles, the first `lead` m upstream of
        `anchor_xy` along `lane` (the microsim stand-in for srunner's
        source->sink ActorFlow: a finite platoon sized to cover a
        MicroBench route's traversal window)."""
        s_a, _ = lane.project(anchor_xy)
        first = None
        for k in range(n):
            s = s_a - lead - gap * k
            if not 0.0 <= s <= lane.length:
                continue
            v = self.world.spawn(Vehicle(
                lane.point_at_s(s), yaw=lane.yaw_at_s(s), speed=speed,
                lane=lane, target_speed=speed, type_id=type_id,
                color=color, role="scenario"))
            first = first or v
        return first

    def _perpendicular_lane(self, anchor: np.ndarray,
                            toward: str = "any") -> Optional[Lane]:
        """The driving lane crossing the ego's heading at `anchor`
        (junction scenarios need the crossing road without hardcoding
        town lane ids). toward='left'/'right' picks the lane whose travel
        direction exits to that side of the ego's heading."""
        ego_yaw = _route_pose(self.route, 0.0)[1]
        best, best_lat = None, None
        for lane in self.world.map.lanes.values():
            if lane.lane_type != "driving":
                continue
            s, lat = lane.project(anchor)
            if abs(lat) > 6.0 or not 0.0 < s < lane.length:
                continue
            rel = math.remainder(lane.yaw_at_s(s) - ego_yaw, 2 * math.pi)
            if abs(abs(rel) - math.pi / 2) > 0.5:
                continue
            if toward == "left" and rel < 0:
                continue
            if toward == "right" and rel > 0:
                continue
            if best_lat is None or abs(lat) < best_lat:
                best, best_lat = lane, abs(lat)
        return best

    def _anchor(self, at_s: float) -> np.ndarray:
        return _route_pose(self.route, at_s)[0]

    def _junction_anchor(self, at_s: float) -> np.ndarray:
        """First route point inside a junction at/after `at_s` (junction
        scenarios are placed by approach arc length; the conflict
        geometry lives in the junction interior)."""
        route = np.asarray(self.route, float)[:, :2]
        seg = np.linalg.norm(np.diff(route, axis=0), axis=1)
        cum = np.concatenate([[0.0], np.cumsum(seg)])
        i0 = int(np.searchsorted(cum, min(max(at_s, 0.0), cum[-1])))
        for p in route[i0:]:
            if self.world.map.in_junction(p):
                return p
        return self._anchor(at_s)

    def _arrival_lead(self, at_s: float, flow_speed: float,
                      ego_mean_speed: float = 6.5) -> float:
        """Upstream offset so a flow vehicle reaches the anchor roughly
        when the ego does (spawned at t=0, the encounter happens at
        ego-arrival time)."""
        return flow_speed * at_s / ego_mean_speed

    # -- Merging ability (flow/merge scenarios) --------------------------------
    def _enter_actor_flow(self, at_s: float) -> Optional[Dict]:
        """Ego crosses the junction and must enter a same-direction flow
        on the exit road (enter_actor_flow.py)."""
        lane_out = self.world.map.closest_lane(self.route[-1])
        anchor = self._junction_anchor(at_s)
        first = self._spawn_flow(
            lane_out, anchor, n=5, gap=28.0, speed=6.0,
            lead=self._arrival_lead(at_s, 6.0) - 14.0)
        return {"first_actor": _actor_rec(first)} if first else None

    def _interurban_actor_flow(self, at_s: float) -> Optional[Dict]:
        """Oncoming flow on the opposite lane while the ego turns left
        off an interurban (non-signalized) road (interurban_actor_flow)."""
        lane_in = self.world.map.closest_lane(self.route[0])
        opp = self.world.map.lanes.get(lane_in.opposite)
        if opp is None:
            return None
        anchor = self._junction_anchor(at_s)
        first = self._spawn_flow(
            opp, anchor, n=4, gap=30.0, speed=7.0,
            lead=self._arrival_lead(at_s, 7.0) - 40.0,
            type_id="vehicle.audi.etron", color="120,130,140")
        return {"first_actor": _actor_rec(first)} if first else None

    def _interurban_advanced_actor_flow(self, at_s: float
                                        ) -> Optional[Dict]:
        """Left turn through BOTH an oncoming flow and a crossing flow
        (interurban_advanced_actor_flow.py)."""
        rec = self._interurban_actor_flow(at_s)
        cross = self._perpendicular_lane(self._junction_anchor(at_s))
        if cross is not None:
            self._spawn_flow(cross, self._junction_anchor(at_s), n=3, gap=34.0,
                             speed=5.0,
                             lead=self._arrival_lead(at_s, 5.0) - 30.0,
                             type_id="vehicle.nissan.micra",
                             color="150,120,60")
        return rec

    def _merger_into_slow_traffic(self, at_s: float,
                                  slow_speed: float = 3.5
                                  ) -> Optional[Dict]:
        """Ego merges from an entry ramp into slow traffic on the main
        road (merger_into_slow_traffic.py; town='highway', ramp='entry')."""
        ramp = self.world.map.closest_lane(self.route[0])
        main = self.world.map.lanes.get(ramp.left)
        if main is None:
            return None
        anchor = self._anchor(at_s)
        first = self._spawn_flow(
            main, anchor, n=5, gap=16.0, speed=slow_speed,
            lead=self._arrival_lead(at_s, slow_speed) - 8.0,
            type_id="vehicle.carlamotors.carlacola", color="90,90,110")
        return {"first_actor": _actor_rec(first)} if first else None

    def _merger_into_slow_traffic_v2(self, at_s: float) -> Optional[Dict]:
        """V2: slow traffic on BOTH main lanes, so the merge gap must be
        found rather than bypassed (merger_into_slow_traffic_v2)."""
        rec = self._merger_into_slow_traffic(at_s)
        ramp = self.world.map.closest_lane(self.route[0])
        main = self.world.map.lanes.get(ramp.left)
        inner = self.world.map.lanes.get(main.left) if main else None
        if inner is not None:
            self._spawn_flow(inner, self._anchor(at_s), n=4, gap=18.0,
                             speed=3.5,
                             lead=self._arrival_lead(at_s, 3.5) - 16.0,
                             type_id="vehicle.volkswagen.t2",
                             color="110,90,80")
        return rec

    def _highway_exit(self, at_s: float) -> Optional[Dict]:
        """Flow on the outer highway lane that the ego must cross to
        reach the exit ramp (highway_exit.py; town='highway',
        ramp='exit'; ego starts on an inner lane)."""
        lane_out = self.world.map.closest_lane(self.route[-1])  # ramp
        flow_lane = self.world.map.lanes.get(lane_out.left)
        if flow_lane is None:
            return None
        anchor = self._anchor(at_s)
        first = self._spawn_flow(
            flow_lane, anchor, n=4, gap=34.0, speed=6.5,
            lead=self._arrival_lead(at_s, 6.5) - 30.0,
            type_id="vehicle.mercedes.sprinter", color="200,200,205")
        return {"first_actor": _actor_rec(first)} if first else None

    def _sequential_lane_change(self, at_s: float) -> Dict:
        """Two staggered slow vehicles (ego lane + the next one over)
        force two consecutive lane changes (sequential_lane_change.py);
        the expert shifts two lane widths across the span."""
        w = self.world
        ego_lane = w.map.closest_lane(self.route[0])
        mid = w.map.lanes.get(ego_lane.left)
        pos, yaw = _route_pose(self.route, at_s)
        first = w.spawn(Vehicle(pos, yaw=yaw, speed=2.0, lane=ego_lane,
                                target_speed=2.0,
                                type_id="vehicle.volkswagen.t2",
                                color="170,140,60", role="scenario"))
        last = first
        if mid is not None:
            s_m, _ = mid.project(self._anchor(at_s + 16.0))
            last = w.spawn(Vehicle(mid.point_at_s(s_m),
                                   yaw=mid.yaw_at_s(s_m), speed=2.0,
                                   lane=mid, target_speed=2.0,
                                   type_id="vehicle.mercedes.sprinter",
                                   color="140,150,170", role="scenario"))
        return {"first_actor": _actor_rec(first),
                "last_actor": _actor_rec(last),
                "direction": "left", "lanes": 2}

    def _parking_exit(self, at_s: float) -> Dict:
        """Parked vehicles boxing in the ego's parking slot; the ego must
        pull out and merge onto the driving lane (parking_exit.py; route
        spec sets parking_exit=true so the planner prepends the merge)."""
        w = self.world
        park = next((l for l in w.map.lanes.values()
                     if l.lane_type == "parking"), None)
        assert park is not None, "ParkingExit needs a parking lane"
        ego_s, _ = park.project(w.ego.position if w.ego is not None
                                else self.route[0])
        front = w.spawn(Vehicle(park.point_at_s(ego_s + 8.0),
                                yaw=park.yaw_at_s(ego_s + 8.0),
                                behavior="parked",
                                type_id="vehicle.bmw.grandtourer",
                                color="40,60,90", role="scenario"))
        rear = w.spawn(Vehicle(park.point_at_s(max(ego_s - 8.0, 0.0)),
                               yaw=park.yaw_at_s(max(ego_s - 8.0, 0.0)),
                               behavior="parked",
                               type_id="vehicle.seat.leon",
                               color="90,90,90", role="scenario"))
        return {"first_actor": _actor_rec(front),
                "last_actor": _actor_rec(rear)}

    # -- junction-turn variants -------------------------------------------------
    def _non_signalized_junction_left_turn(self, at_s: float
                                           ) -> Optional[Dict]:
        """Crossing traffic from the right cuts the ego's left-turn path
        at an unsignalized junction (non_signalized_junction_left_turn)."""
        anchor = self._junction_anchor(at_s)
        cross = self._perpendicular_lane(anchor)
        if cross is None:
            return None
        first = self._spawn_flow(
            cross, anchor, n=3, gap=30.0, speed=5.5,
            lead=self._arrival_lead(at_s, 5.5) - 25.0,
            type_id="vehicle.dodge.charger_2020", color="50,50,60")
        return {"first_actor": _actor_rec(first)} if first else None

    def _non_signalized_junction_right_turn(self, at_s: float
                                            ) -> Optional[Dict]:
        """Ego turns right and must merge into the target lane's flow
        (non_signalized_junction_right_turn)."""
        lane_out = self.world.map.closest_lane(self.route[-1])
        anchor = self._junction_anchor(at_s)
        first = self._spawn_flow(
            lane_out, anchor, n=4, gap=30.0, speed=5.0,
            lead=self._arrival_lead(at_s, 5.0) - 20.0,
            type_id="vehicle.mini.cooper_s", color="150,40,40")
        return {"first_actor": _actor_rec(first)} if first else None

    def _non_signalized_junction_left_turn_enter_flow(
            self, at_s: float) -> Optional[Dict]:
        """Left turn INTO a same-direction flow on the target lane
        (non_signalized_junction_left_turn_enter_flow)."""
        return self._non_signalized_junction_right_turn(at_s)

    def _signalized_junction_right_turn(self, at_s: float
                                        ) -> Optional[Dict]:
        """Signalized variant: right on green into the target-lane flow
        (signalized_junction_right_turn.py)."""
        return self._non_signalized_junction_right_turn(at_s)

    def _signalized_junction_left_turn_enter_flow(
            self, at_s: float) -> Optional[Dict]:
        """Signalized variant of the left-turn-into-flow
        (signalized_junction_left_turn_enter_flow)."""
        return self._non_signalized_junction_right_turn(at_s)

    def _t_junction(self, at_s: float) -> Optional[Dict]:
        """Through/turn traversal of a T junction with oncoming traffic
        (t_junction.py; town='crossing' with t_junction=true)."""
        return self._interurban_actor_flow(at_s)

    def _vanilla_non_signalized_turn(self, at_s: float) -> Optional[Dict]:
        """Plain unsignalized junction turn -- route-only scenario
        (vanilla non-signalized turn; no adversarial actors)."""
        return None

    def _vanilla_non_signalized_turn_encounter_stopsign(
            self, at_s: float) -> Optional[Dict]:
        """Turn governed by a stop sign (town spec provides the sign;
        the criteria's RunningStopTest scores it)."""
        return None

    def _vanilla_signalized_turn_encounter_green_light(
            self, at_s: float) -> Optional[Dict]:
        """The approach light is re-phased to green as the ego arrives."""
        self.world.light_triggers.append(
            {"position": self._anchor(at_s), "distance": 30.0,
             "state": "green", "fired": False})
        return None

    def _vanilla_signalized_turn_encounter_red_light(
            self, at_s: float) -> Optional[Dict]:
        """The approach light is re-phased to red as the ego arrives; the
        ego must stop through the red phase before turning."""
        self.world.light_triggers.append(
            {"position": self._anchor(at_s), "distance": 30.0,
             "state": "red", "fired": False})
        return None

    # -- Emergency_Brake ability --------------------------------------------------
    def _hard_break_route(self, at_s: float,
                          trigger_distance: float = 20.0) -> Dict:
        """A lead vehicle slams to a stop when the ego closes in, holds,
        then resumes (hard_break_route.py -- note the reference's own
        'break' spelling)."""
        pos, yaw = _route_pose(self.route, at_s)
        lane = self.world.map.closest_lane(pos)
        lead = self.world.spawn(Vehicle(
            pos, yaw=yaw, speed=5.5, lane=lane, target_speed=5.5,
            type_id="vehicle.tesla.model3", color="25,25,30",
            role="scenario"))
        lead.brake_trigger_distance = trigger_distance
        lead.brake_hold = 5.0
        return {"first_actor": _actor_rec(lead)}

    def _opposite_vehicle_taking_priority(self, at_s: float,
                                          trigger_distance: float = 32.0
                                          ) -> Dict:
        """A crossing vehicle takes priority at an unsignalized junction,
        dashing across as the ego approaches
        (opposite_vehicle_taking_priority.py)."""
        return self._opposite_vehicle_running_red_light(
            at_s, trigger_distance=trigger_distance)

    def _parking_cut_in(self, at_s: float,
                        trigger_distance: float = 28.0) -> Dict:
        """A vehicle parked in the parking lane pulls out into the ego
        lane (parking_cut_in.py; town has parking_lane=true)."""
        w = self.world
        ego_lane = w.map.closest_lane(self.route[0])
        park = next((l for l in w.map.lanes.values()
                     if l.lane_type == "parking"), None)
        assert park is not None, "ParkingCutIn needs a parking lane"
        s_p, _ = park.project(self._anchor(at_s))
        puller = w.spawn(Vehicle(park.point_at_s(s_p),
                                 yaw=park.yaw_at_s(s_p),
                                 behavior="parked", target_speed=5.0,
                                 type_id="vehicle.ford.mustang",
                                 color="120,20,20", role="scenario"))
        puller.unblock_trigger_distance = trigger_distance
        puller.unblock_delay = 0.0
        puller.lane = ego_lane
        return {"first_actor": _actor_rec(puller)}

    def _pedestrian_crossing(self, at_s: float,
                             trigger_distance: float = 22.0) -> Dict:
        """A group of three pedestrians crosses together
        (pedestrian_crossing.py: three walkers on a junction crosswalk)."""
        pos, yaw = _route_pose(self.route, at_s)
        n = _left_normal(yaw)
        fwd = np.array([math.cos(yaw), math.sin(yaw)])
        w = self.world
        first = None
        for k, ds in enumerate((-1.2, 0.0, 1.2)):
            start = pos + n * -5.0 + fwd * ds
            path = np.stack([pos + n * -2.0 + fwd * ds,
                             pos + n * 4.5 + fwd * ds], 0)
            walker = w.spawn(Walker(
                start, path=path, trigger_distance=trigger_distance,
                walk_speed=1.3 + 0.15 * k,
                type_id=f"walker.pedestrian.{k + 1:04d}",
                role="scenario"))
            walker.yaw = yaw + math.pi / 2
            first = first or walker
        return {"first_actor": _actor_rec(first)}

    def _vehicle_turning_route(self, at_s: float,
                               trigger_distance: float = 20.0) -> Dict:
        """A cyclist cuts across the ego's path as it turns through the
        junction (vehicle_turning_route.py)."""
        pos, yaw = _route_pose(self.route, at_s)
        n = _left_normal(yaw)
        bike = self.world.spawn(Vehicle(
            pos + n * -8.0, yaw=yaw + math.pi / 2, speed=0.0,
            target_speed=3.5, type_id="vehicle.bh.crossbike",
            base_type="bicycle", extent=(0.9, 0.4),
            color="20,120,160", role="scenario"))
        bike.behavior = "scripted"
        bike._trigger = ("dash", trigger_distance, 3.5)
        return {"first_actor": _actor_rec(bike)}

    def _vehicle_turning_route_pedestrian(self, at_s: float,
                                          trigger_distance: float = 18.0
                                          ) -> Dict:
        """A pedestrian steps into the ego's turning path
        (vehicle_turning_route_pedestrian variant)."""
        pos, yaw = _route_pose(self.route, at_s)
        n = _left_normal(yaw)
        start = pos + n * -6.0
        path = np.stack([pos + n * -2.0, pos + n * 4.0], 0)
        walker = self.world.spawn(Walker(
            start, path=path, trigger_distance=trigger_distance,
            role="scenario"))
        walker.yaw = yaw + math.pi / 2
        return {"first_actor": _actor_rec(walker)}

    def _control_loss(self, at_s: float, events: int = 3,
                      duration: float = 0.5, bias: float = 0.1
                      ) -> Optional[Dict]:
        """Transient steering faults the agent must absorb
        (control_loss.py injects control noise at route triggers)."""
        for k in range(events):
            self.world.control_faults.append({
                "position": self._anchor(at_s + 14.0 * k),
                "distance": 3.0, "duration": duration,
                "steer_bias": bias * (1.0 if k % 2 == 0 else -1.0),
                "started": None})
        return None

    def _crossing_bicycle_flow(self, at_s: float) -> Dict:
        """Bicycles crossing the junction path (crossing_bicycle_flow.py)."""
        pos, yaw = _route_pose(self.route, at_s)
        n = _left_normal(yaw)
        w = self.world
        first = None
        for k in range(3):
            start = pos + n * (-12.0 - 6.0 * k)
            bike = w.spawn(Vehicle(start, yaw=yaw + math.pi / 2, speed=4.0,
                                   target_speed=4.0,
                                   type_id="vehicle.gazelle.omafiets",
                                   base_type="bicycle", extent=(0.9, 0.4),
                                   color="150,90,30", role="scenario"))
            bike.behavior = "scripted"      # straight-line: no lane to hold

            first = first or bike
        return {"first_actor": _actor_rec(first)}


def _snake(name: str) -> str:
    name = name.replace("_", "")          # T_Junction -> TJunction
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def scripted_tick(world: SimWorld) -> None:
    """Advance 'scripted' vehicles (straight-line constant speed).

    A vehicle with `_trigger = ("dash", distance, speed)` holds still
    until the ego comes within `distance`, then dashes at `speed`
    (red-light-runner mechanics)."""
    ego_pos = world.ego.position if world.ego is not None else None
    for actor in world.actors:
        if not (isinstance(actor, Vehicle) and actor.behavior == "scripted"
                and actor.alive):
            continue
        trigger = getattr(actor, "_trigger", None)
        if trigger is not None and ego_pos is not None:
            kind, dist, speed = trigger
            if np.linalg.norm(ego_pos - actor.position) < dist:
                actor.speed = float(speed)
                actor._trigger = None
            else:
                continue
        actor.position = actor.position + actor.velocity * world.dt

"""CARLA leaderboard plugin for expert data collection.

Copy of `simlingo_tpu/agent/carla_data_agent.py`, its class named for the
port, `SimLingoTorchDataAgent`. It runs no model, so it needs no GPU. It
exists only where `leaderboard` imports (inside a CARLA leaderboard
environment, or under test doubles); elsewhere it is None.

Counterpart of reference `team_code/data_agent.py`'s leaderboard plumbing:
wires the simulator-independent DataCollector (agent/data_agent.py) +
privileged expert to live CARLA sensors. Sensors follow the reference's
data-collection rig (normal + pose-augmented RGB at 1024x512 FOV 110).
"""

from __future__ import annotations

import os

import numpy as np


def get_entry_point():
    return "SimLingoTorchDataAgent"


try:
    from leaderboard.autoagents import autonomous_agent

    class SimLingoTorchDataAgent(autonomous_agent.AutonomousAgent):
        def setup(self, path_to_conf_file, route_index=None):
            from simlingo_tpu_torch.agent.data_agent import DataCollector
            from simlingo_tpu_torch.agent.route_planner import CarlaRoutePlanner
            from simlingo_tpu_torch.expert.route_planner import (
                PrivilegedRoutePlanner)

            from simlingo_tpu_torch.expert.scenarios import ScenarioManager

            self.track = autonomous_agent.Track.MAP
            save_path = os.environ.get("SAVE_PATH", path_to_conf_file)
            self.collector = DataCollector(save_path)
            self.planner = CarlaRoutePlanner(min_distance=7.5,
                                             max_distance=50.0)
            # densified 0.1 m route the expert steers on (reference
            # privileged_route_planner.py); lane changes / obstacle
            # bypasses are applied here
            self.priv_planner = PrivilegedRoutePlanner()
            # route re-planning around injected scenarios (reference
            # autopilot.py:461-903 via CarlaDataProvider.active_scenarios)
            self.scenarios = ScenarioManager(self.priv_planner)
            self.initialized = False

        def sensors(self):
            cam = {"type": "sensor.camera.rgb", "x": -1.5, "y": 0.0,
                   "z": 2.0, "roll": 0.0, "pitch": 0.0, "yaw": 0.0,
                   "width": 1024, "height": 512, "fov": 110}
            aug = self.collector.sample_camera_augmentation()
            cam_aug = dict(cam, y=aug["translation"], yaw=aug["rotation"],
                           id="rgb_augmented")
            return [dict(cam, id="rgb_front"), cam_aug,
                    {"type": "sensor.lidar.ray_cast", "x": 0.0, "y": 0.0,
                     "z": 2.5, "roll": 0.0, "pitch": 0.0, "yaw": -90.0,
                     "rotation_frequency": 10, "points_per_second": 600000,
                     "id": "lidar"},
                    {"type": "sensor.other.imu", "x": 0, "y": 0, "z": 0,
                     "roll": 0, "pitch": 0, "yaw": 0, "sensor_tick": 0.05,
                     "id": "imu"},
                    {"type": "sensor.other.gnss", "x": 0, "y": 0, "z": 0,
                     "roll": 0, "pitch": 0, "yaw": 0, "sensor_tick": 0.01,
                     "id": "gps"},
                    {"type": "sensor.speedometer", "reading_frequency": 20,
                     "id": "speed"}]

        def run_step(self, input_data, timestamp, sensors=None):
            import carla
            from simlingo_tpu_torch.expert.autopilot import ExpertObservation

            if not self.initialized:
                self.planner.set_route(self._global_plan_world_coord)
                sparse = np.asarray(
                    [p for p, _ in self.planner.route])[:, :2]
                self.priv_planner.set_route(sparse)
                for obstacle in self._static_obstacles():
                    self.priv_planner.add_obstacle(obstacle)
                self.initialized = True

            rgb = input_data["rgb_front"][1][:, :, :3][:, :, ::-1]
            rgb_aug = input_data["rgb_augmented"][1][:, :, :3][:, :, ::-1]
            gps = input_data["gps"][1]
            compass = input_data["imu"][1][-1]
            speed = input_data["speed"][1]["speed"]
            pos = self.planner.convert_gps_to_carla(gps)
            tp, tp_next = self.planner.target_points(pos[:2], compass)

            # privileged actors: the MAP-track harness exposes the world
            # via CarlaDataProvider; gather nearby dynamic actors in ego frame
            actors = self._gather_actors(pos, compass)

            # scenario route management: translate the patched harness's
            # active_scenarios into planner-space records and tick
            self.scenarios.set_active(self._active_scenario_records())
            oncoming = [a for a in actors
                        if abs(a.get("yaw", 0.0)) > 2.0]  # facing the ego
            scenario_result = self.scenarios.tick(
                8.0, speed, pos[:2], oncoming)

            inp = self.priv_planner.ego_inputs(pos[:2], compass)
            obs = ExpertObservation(
                pos_global=pos[:2], theta=compass, speed=speed,
                speed_limit=8.0,
                route=inp["route"], route_original=inp["route_original"],
                target_point=tp, target_point_next=tp_next, actors=actors,
                changed_route=inp["changed_route"])
            lidar = input_data.get("lidar")
            lidar_pts = (np.asarray(lidar[1])[:, :3]
                         if lidar is not None else None)
            lane_info = self._ego_lane_info(pos)
            if lane_info:
                actors = list(actors) + [dict(lane_info, **{
                    "class": "ego_info"})]
            out = self.collector.tick(obs, rgb=np.ascontiguousarray(rgb),
                                      rgb_augmented=np.ascontiguousarray(
                                          rgb_aug),
                                      boxes=actors,
                                      scenario_result=scenario_result,
                                      lidar_half_sweep=lidar_pts,
                                      extra_measurements=lane_info)
            control = carla.VehicleControl()
            control.steer = float(out["steer"])
            control.throttle = float(out["throttle"])
            control.brake = float(out["brake"])
            return control

        def _ego_lane_info(self, pos):
            """Map-derived lane/junction context (reference
            data_agent.py:594-710 ego_info): lane counts per direction,
            ego lane index from the leftmost same-direction lane, lane
            markings, distance to the next junction."""
            try:
                import carla
                from srunner.scenariomanager.carla_data_provider import (
                    CarlaDataProvider)
                world_map = CarlaDataProvider.get_map()
                loc = carla.Location(x=float(pos[0]), y=float(pos[1]))
                wp = world_map.get_waypoint(loc)
                info = {
                    "is_in_junction": bool(wp.is_junction),
                    "lane_marking_left": str(wp.left_lane_marking.type),
                    "lane_marking_right": str(wp.right_lane_marking.type),
                }
                # junction distance: walk forward along the lane
                if wp.is_junction:
                    info["distance_to_junction"] = 0.0
                else:
                    info["distance_to_junction"] = None
                    probe = wp
                    travelled = 0.0
                    for _ in range(40):
                        nxt = probe.next(2.0)
                        if not nxt:
                            break
                        travelled += 2.0
                        probe = nxt[0]
                        if probe.is_junction:
                            info["distance_to_junction"] = travelled
                            break
                # count driving lanes per direction; index from the left
                ego_dir = wp.lane_id / abs(wp.lane_id)
                n_same, n_opp, left_of_ego = 1, 0, 0
                for side, stepper in (("left", "get_left_lane"),
                                      ("right", "get_right_lane")):
                    probe, passed_opposite = wp, False
                    for _ in range(8):
                        probe = getattr(probe, stepper)()
                        if probe is None or probe.lane_type != \
                                carla.LaneType.Driving:
                            break
                        same = (probe.lane_id / abs(probe.lane_id)) == ego_dir
                        if same and not passed_opposite:
                            n_same += 1
                            if side == "left":
                                left_of_ego += 1
                        elif not same:
                            passed_opposite = True
                            n_opp += 1
                info.update(num_lanes_same_direction=n_same,
                            num_lanes_opposite_direction=n_opp,
                            ego_lane_number=left_of_ego)
                return info
            except Exception:
                return {}

        def _static_obstacles(self):
            """Global positions of static props blocking the route
            (parked-vehicle scenarios) to bypass via the planner."""
            try:
                from srunner.scenariomanager.carla_data_provider import (
                    CarlaDataProvider)
                world = CarlaDataProvider.get_world()
                return [[a.get_location().x, a.get_location().y]
                        for a in world.get_actors().filter("*static.prop*")]
            except Exception:
                return []

        def _gather_actors(self, ego_pos, ego_yaw):
            """Nearby dynamic actors as full expert dicts: ego-frame
            position/yaw, speed, half-extents, last control (used by the
            forecast-OBB constraints, reference autopilot.py:1176-1741)."""
            try:
                from srunner.scenariomanager.carla_data_provider import (
                    CarlaDataProvider)
                from simlingo_tpu_torch.utils.geometry import inverse_conversion_2d
                import numpy as _np
                world = CarlaDataProvider.get_world()
                out = []
                for pattern in ("*vehicle*", "*walker*"):
                    for actor in world.get_actors().filter(pattern):
                        loc = actor.get_location()
                        rel = inverse_conversion_2d(
                            _np.array([loc.x, loc.y]), ego_pos[:2], ego_yaw)
                        if _np.linalg.norm(rel) >= 50:
                            continue
                        vel = actor.get_velocity()
                        rec = {
                            "position": rel.tolist(),
                            "yaw": float(_np.deg2rad(
                                actor.get_transform().rotation.yaw)
                                - ego_yaw),
                            "speed": float(_np.hypot(vel.x, vel.y)),
                            "type_id": actor.type_id,
                            "id": actor.id,
                        }
                        try:
                            ext = actor.bounding_box.extent
                            rec["extent"] = [float(ext.x), float(ext.y)]
                        except Exception:
                            rec["extent"] = [2.25, 1.0]
                        try:
                            ctrl = actor.get_control()
                            rec["steer"] = float(getattr(ctrl, "steer", 0.0))
                            rec["throttle"] = float(
                                getattr(ctrl, "throttle", 0.0))
                            rec["brake"] = bool(
                                getattr(ctrl, "brake", 0.0) > 0.5)
                            if hasattr(ctrl, "direction"):  # walker control
                                rec["direction"] = [
                                    float(ctrl.direction.x),
                                    float(ctrl.direction.y)]
                        except Exception:
                            pass
                        if "base_type" in getattr(actor, "attributes", {}):
                            rec["base_type"] = actor.attributes["base_type"]
                        out.append(rec)
                return out
            except Exception:
                return []

        def _active_scenario_records(self):
            """Translate CarlaDataProvider.active_scenarios (exposed by the
            patched data-collection harness, reference autopilot.py:646-662)
            into the ScenarioManager's plain-dict records."""
            try:
                from srunner.scenariomanager.carla_data_provider import (
                    CarlaDataProvider)
                records = []
                for scenario_type, data in getattr(
                        CarlaDataProvider, "active_scenarios", []):
                    def actor_rec(a):
                        if a is None:
                            return None
                        loc = a.get_location()
                        rec = {"position": [loc.x, loc.y]}
                        try:
                            ext = a.bounding_box.extent
                            rec["extent"] = [float(ext.x), float(ext.y)]
                        except Exception:
                            rec["extent"] = [2.5, 1.0]
                        return rec
                    first = actor_rec(data[0]) if len(data) else None
                    if first is None:
                        continue
                    rec = {"type": scenario_type, "first_actor": first}
                    last = actor_rec(data[1]) if len(data) > 1 else None
                    if last is not None:
                        rec["last_actor"] = last
                    if len(data) > 2 and isinstance(data[2], str):
                        rec["direction"] = data[2]
                    records.append(rec)
                return records
            except Exception:
                return []

        def destroy(self, results=None):
            self.collector.destroy()

except ImportError:
    SimLingoTorchDataAgent = None

"""CARLA Leaderboard 2.0 agent plugin of the port.

Counterpart of `simlingo_tpu/agent/carla_agent.py`: the plugin contract
(`get_entry_point()` and an `AutonomousAgent` with setup / sensors /
run_step / destroy, leaderboard/autoagents/autonomous_agent.py) around the
port's simulator-independent `LingoAgent`: the camera, IMU, GNSS and
speedometer sensors, GPS -> CARLA conversion, UKF filtering, the route
planner's target points and the control conversion, with optional
per-route scenario records (`SIMLINGO_RECORD_DIR`,
`SIMLINGO_RECORD_EVERY_N`) and the agent's per-tick metric file
(`SIMLINGO_METRIC_INFO`, agent/agent.py).

`setup()` loads the checkpoint at `path_to_conf_file` into
`presets.internvl2_1b()` through `core/checkpoint.py:load_hf_checkpoint`
and builds `LingoAgent` with the default `AgentConfig()` (CoT, int8 LLM,
speculative) on `device` (a class attribute, cuda; the agent runs on the
card and raises without one), the tokenizer from `SIMLINGO_TOKENIZER`.
The class is named for the port, `SimLingoTorchAgent`. It exists only
where `leaderboard` imports (inside a CARLA leaderboard environment, or
under test doubles); elsewhere it is None.
"""

from __future__ import annotations

import math
import os

import numpy as np


def get_entry_point():
    return "SimLingoTorchAgent"


try:
    from leaderboard.autoagents import autonomous_agent

    class SimLingoTorchAgent(autonomous_agent.AutonomousAgent):
        """Leaderboard wrapper around the port's LingoAgent."""

        logger = None          # ScenarioLogger; set in setup() when enabled
        device = "cuda"

        def setup(self, path_to_conf_file, route_index=None):
            from simlingo_tpu_torch.agent.agent import LingoAgent
            from simlingo_tpu_torch.agent.config import AgentConfig
            from simlingo_tpu_torch.agent.route_planner import CarlaRoutePlanner
            from simlingo_tpu_torch.core import checkpoint as ckpt
            from simlingo_tpu_torch.core.presets import internvl2_1b
            from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer

            self.track = autonomous_agent.Track.SENSORS
            model_cfg = internvl2_1b()
            params = ckpt.load_hf_checkpoint(path_to_conf_file, model_cfg)
            tok_path = os.environ.get("SIMLINGO_TOKENIZER")
            self.agent = LingoAgent(params, model_cfg, AgentConfig(),
                                    tokenizer=SimLingoTokenizer(tok_path),
                                    device=self.device)
            self.planner = CarlaRoutePlanner(min_distance=7.5,
                                             max_distance=50.0)
            self.initialized = False
            # per-route state records for post-hoc infraction replay
            # (agent/scenario_logger.py renders them)
            self.logger = None
            record_dir = os.environ.get("SIMLINGO_RECORD_DIR")
            if record_dir:
                from simlingo_tpu_torch.agent.scenario_logger import ScenarioLogger
                idx = str(route_index if route_index is not None else 0)
                self.logger = ScenarioLogger(
                    save_path=os.path.join(record_dir, idx),
                    route_index=idx, log_every_n=int(
                        os.environ.get("SIMLINGO_RECORD_EVERY_N", "1")))

        def sensors(self):
            from simlingo_tpu_torch.agent.config import AgentConfig
            c = AgentConfig()
            x, y, z = c.camera_pos
            return [
                {"type": "sensor.camera.rgb", "x": x, "y": y, "z": z,
                 "roll": 0.0, "pitch": 0.0, "yaw": 0.0,
                 "width": c.camera_width, "height": c.camera_height,
                 "fov": c.camera_fov, "id": "rgb_front"},
                {"type": "sensor.other.imu", "x": 0.0, "y": 0.0, "z": 0.0,
                 "roll": 0.0, "pitch": 0.0, "yaw": 0.0,
                 "sensor_tick": 0.05, "id": "imu"},
                {"type": "sensor.other.gnss", "x": 0.0, "y": 0.0, "z": 0.0,
                 "roll": 0.0, "pitch": 0.0, "yaw": 0.0,
                 "sensor_tick": 0.01, "id": "gps"},
                {"type": "sensor.speedometer", "reading_frequency": 20,
                 "id": "speed"},
            ]

        def run_step(self, input_data, timestamp, sensors=None):
            import carla
            from simlingo_tpu_torch.agent.agent import AgentFrame

            if not self.initialized:
                self.planner.set_route(self._global_plan_world_coord)
                self.initialized = True

            rgb = input_data["rgb_front"][1][:, :, :3][:, :, ::-1]     # BGRA -> RGB
            gps = input_data["gps"][1]
            compass = input_data["imu"][1][-1]
            speed = input_data["speed"][1]["speed"]

            pos = self.planner.convert_gps_to_carla(gps)
            # UKF: fuse noisy GPS / IMU / speed through the bicycle model
            fpos, fyaw, fspeed = self.agent.filter_ego_state(
                pos[:2], compass, speed)
            tp, tp_next = self.planner.target_points(fpos, fyaw)
            frame = AgentFrame(rgb=np.ascontiguousarray(rgb), speed=fspeed,
                               target_point=tp, next_target_point=tp_next,
                               compass=fyaw, gps=pos)
            out = self.agent.run_step(frame)
            control = carla.VehicleControl()
            control.steer = float(out["steer"])
            control.throttle = float(out["throttle"])
            control.brake = float(out["brake"])
            if self.logger is not None:
                self._log_tick(fpos, fyaw, fspeed, out)
            return control

        def _log_tick(self, fpos, fyaw, fspeed, out):
            """Feed one tick of privileged world state to the scenario
            logger: ego, nearby vehicles, non-green lights, ego control."""
            ego = {"position": list(map(float, fpos[:2])),
                   "yaw": float(fyaw), "velocity": [float(fspeed), 0.0]}
            actors, lights = [], []
            try:
                if self.logger.route is None:
                    self.logger.set_route(np.asarray(
                        [[t.location.x, t.location.y]
                         for t, _ in self._global_plan_world_coord]))
            except Exception:
                pass
            try:
                # privileged world state (evaluation runs have it through
                # the scenario runner); else the ego-only record
                import carla
                from srunner.scenariomanager.carla_data_provider import (
                    CarlaDataProvider)
                world = CarlaDataProvider.get_world()
                ego_actor = CarlaDataProvider.get_hero_actor()

                def state(a):
                    tr, vel = a.get_transform(), a.get_velocity()
                    ext = a.bounding_box.extent
                    return {"position": [tr.location.x, tr.location.y,
                                         tr.location.z],
                            "yaw": math.radians(tr.rotation.yaw),
                            "velocity": [vel.x, vel.y],
                            "extent": (ext.x, ext.y), "id": a.id,
                            "type": a.type_id,
                            "color": a.attributes.get("color", "0,0,0"),
                            "pitch": math.radians(tr.rotation.pitch),
                            "roll": math.radians(tr.rotation.roll)}

                if ego_actor is not None:
                    ego = state(ego_actor)
                actors = [state(a)
                          for a in world.get_actors().filter("*vehicle*")
                          if ego_actor is None or a.id != ego_actor.id]
                for tl in world.get_actors().filter("*traffic_light*"):
                    st = {carla.TrafficLightState.Red: 0,
                          carla.TrafficLightState.Yellow: 1}.get(tl.state)
                    if st is None:
                        continue
                    pos = tl.get_transform().transform(
                        tl.trigger_volume.location)
                    lights.append({
                        "position": [pos.x, pos.y],
                        "yaw": math.radians(tl.get_transform().rotation.yaw),
                        "state": st,
                        "extent": (tl.trigger_volume.extent.x,
                                   tl.trigger_volume.extent.y)})
            except Exception:
                pass  # privileged access unavailable: ego-only record
            try:
                self.logger.log(ego, actors=actors, lights=lights,
                                control={"steer": float(out["steer"]),
                                         "throttle": float(out["throttle"]),
                                         "brake": float(out["brake"])})
            except Exception:
                pass  # recording must never break the evaluation run

        def destroy(self, results=None):
            stats = self.agent.latency_stats()
            print(f"simlingo_tpu_torch agent latency: {stats}")
            if self.logger is not None:
                self.logger.dump()
            self.agent.close()

except ImportError:  # outside a CARLA environment
    SimLingoTorchAgent = None

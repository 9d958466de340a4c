"""Lightweight closed-loop driving simulator (microsim).

Copy of `simlingo_tpu/sim/__init__.py`: a small, deterministic, pure-numpy
world model in place of CARLA's leaderboard / scenario_runner /
Bench2Drive harness, so that closed-loop evaluation of the port's agent
runs in-repo with no simulator binary. The real CARLA path stays available
through the plugin in simlingo_tpu_torch/agent/carla_agent.py; the
microsim's runner emits the same leaderboard-format result JSON
(eval/driving_score.py parses both identically).

Modules:
  map.py       lane-polyline HD map + towns (straight / curved / crossing)
  actors.py    kinematic-bicycle vehicles (IDM + pure pursuit), walkers,
               static props, traffic lights
  world.py     the tick loop, spawning, collision queries
  camera.py    synthetic pinhole RGB + semantics + depth rendering
  scenarios.py Bench2Drive scenario inventory on microsim primitives
  criteria.py  leaderboard infraction criteria + penalty bookkeeping
  runner.py    route runner -> leaderboard-format records
  suite.py     MicroBench route suites + CLI

Not ported yet: route_map.py (it needs labels/route_tools.py) and the
runner's privileged expert driver.
"""

from simlingo_tpu_torch.sim.map import Lane, Road, SimMap
from simlingo_tpu_torch.sim.world import SimWorld
from simlingo_tpu_torch.sim.runner import run_route

__all__ = ["Lane", "Road", "SimMap", "SimWorld", "run_route"]

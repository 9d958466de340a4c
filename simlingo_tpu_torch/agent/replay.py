"""Replay harness: drive the agent against recorded sensor streams.

Copy of `simlingo_tpu/agent/replay.py`.

CARLA cannot run in CI (SURVEY.md hard part #6), so closed-loop behavior is
exercised by replaying a recorded route (the dataset's own format: rgb/*.jpg
+ measurements/*.json.gz) through the full agent stack and comparing the
produced controls against the recorded expert controls.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from simlingo_tpu_torch.agent.agent import AgentFrame, LingoAgent
from simlingo_tpu_torch.data import measurements as M


def replay_route(agent: LingoAgent, route_dir: str,
                 max_frames: Optional[int] = None,
                 start_frame: int = 0) -> List[Dict]:
    """Feed each recorded frame to the agent; collect controls + expert's."""
    mdir = os.path.join(route_dir, "measurements")
    frames = sorted(int(f.split(".")[0]) for f in os.listdir(mdir)
                    if f.endswith(".json.gz"))
    frames = [f for f in frames if f >= start_frame]
    if max_frames is not None:
        frames = frames[:max_frames]

    results = []
    for fi in frames:
        m = M.read_json_gz(os.path.join(mdir, f"{fi:04}.json.gz"))
        img_path = os.path.join(route_dir, "rgb", f"{fi:04}.jpg")
        from simlingo_tpu_torch.data.imageio import load_rgb
        rgb = load_rgb(img_path)
        frame = AgentFrame(
            rgb=rgb,
            speed=float(m["speed"]),
            target_point=np.asarray(m["target_point"], np.float64),
            next_target_point=np.asarray(m["target_point_next"], np.float64),
            compass=float(m.get("theta", 0.0)))
        out = agent.run_step(frame)
        out["expert"] = {"steer": m.get("steer"),
                         "throttle": m.get("throttle"),
                         "brake": m.get("brake")}
        out["frame"] = fi
        results.append(out)
    return results

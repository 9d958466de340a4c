"""Scenario logging for failure analysis and infraction replay.

Copy of `simlingo_tpu/agent/scenario_logger.py` (numpy; matplotlib and
PIL are imported only by the render functions, where they are installed).

Behavioral counterpart of reference `team_code/scenario_logger.py`
(ScenarioLogger) + `tools/infraction_gifs.py`: per-tick records of ego /
other-actor states, traffic lights and the route (RDP-simplified into
oriented boxes), written as `records.json.gz` so infractions can be
replayed and rendered after a run.

Record schema (matches reference `scenario_logger.py:497-535` dump):
  meta_data: {index, town}
  states[t]:  {pos [1,A,2], yaw [1,A,1], vel [1,A,2], extent [1,A,4,2],
               id, type, color, height, pitch, roll}   (ego first, row 0)
  lights[t]:  {pos, yaw, state (0=red 1=yellow -1=unknown), extent}
  route[t]:   {pos, yaw, id, extent}                   (RDP route boxes)
  ego_actions[t] / adv_actions[t]: {steer, throttle, brake}

The replay renderer (`render_replay_frames`) draws each logged tick as a
BEV frame; `make_infraction_gifs` mirrors `tools/infraction_gifs.py`:
for each infraction in a result record it collects the +/- `window`
frames around the infraction frame and writes an animated GIF per
infraction type.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def rdp_simplify(points: np.ndarray, epsilon: float = 0.5) -> np.ndarray:
    """Ramer-Douglas-Peucker polyline simplification."""
    points = np.asarray(points, float)
    if len(points) < 3:
        return points

    def rec(pts):
        start, end = pts[0], pts[-1]
        if len(pts) < 3:
            return [start, end]
        d = end - start
        norm = np.linalg.norm(d)
        if norm < 1e-9:
            dists = np.linalg.norm(pts - start, axis=1)
        else:
            rel = start - pts
            dists = np.abs(d[0] * rel[:, 1] - d[1] * rel[:, 0]) / norm
        i = int(np.argmax(dists))
        if dists[i] > epsilon:
            left = rec(pts[: i + 1])
            right = rec(pts[i:])
            return left[:-1] + right
        return [start, end]

    return np.asarray(rec(points))


def _corners(extent_xy: Sequence[float]) -> List[List[float]]:
    """Half-extents (x fwd, y right) -> the reference's 4-corner box layout
    ([ey, ex], [ey, -ex], [-ey, -ex], [-ey, ex]; scenario_logger.py:253)."""
    ex, ey = float(extent_xy[0]), float(extent_xy[1])
    return [[ey, ex], [ey, -ex], [-ey, -ex], [-ey, ex]]


def route_as_boxes(route: np.ndarray, ego_pos: Optional[Sequence[float]],
                   ego_extent: Sequence[float] = (2.45, 1.0),
                   rdp_epsilon: float = 0.5, roi: float = 30.0) -> Dict:
    """RDP-simplify the route and represent each segment as an oriented box
    (reference route_as_boxes, scenario_logger.py:425-475): midpoint pos,
    segment yaw, half-length x ego-width extents. Segments beyond `roi` of
    the ego (after the first) are dropped."""
    short = rdp_simplify(np.asarray(route, float)[:, :2], rdp_epsilon)
    if len(short) < 2:
        return {"pos": [], "yaw": [], "id": [], "extent": []}
    vectors = short[1:] - short[:-1]
    midpoints = short[:-1] + vectors / 2.0
    norms = np.linalg.norm(vectors, axis=1)
    angles = np.arctan2(vectors[:, 1], vectors[:, 0])
    pos, yaw, ids, extent = [], [], [], []
    for i, mid in enumerate(midpoints):
        if ego_pos is not None and 0 < i < 10:
            if np.linalg.norm(short[i] - np.asarray(ego_pos[:2])) > roi:
                continue
        pos.append([float(mid[0]), float(mid[1])])
        yaw.append([float(angles[i])])
        ids.append([int(i)])
        extent.append(_corners((norms[i] / 2.0, ego_extent[1])))
    return {"pos": [pos], "yaw": [yaw], "id": [ids], "extent": [extent]}


class ScenarioLogger:
    """Backend-agnostic: the CARLA plugin feeds plain dicts; offline tests
    feed synthesized ones. Light states: 0=red, 1=yellow, -1=unknown."""

    def __init__(self, save_path: Optional[str] = None,
                 route_index: str = "0", log_every_n: int = 1,
                 town: str = "Unknown", roi: float = 30.0,
                 rdp_epsilon: float = 0.5):
        self.save_path = save_path
        self.route_index = route_index
        self.log_every_n = log_every_n
        self.town = town
        self.roi = roi
        self.rdp_epsilon = rdp_epsilon
        self.states: List[Dict] = []
        self.lights: List[Dict] = []
        self.route_boxes: List[Dict] = []
        self.ego_actions: List[Dict] = []
        self.adv_actions: List[Dict] = []
        self.route: Optional[np.ndarray] = None
        self.tick = 0

    def set_route(self, route_points: np.ndarray) -> None:
        self.route = np.asarray(route_points, float)[:, :2]

    @staticmethod
    def _actor_state(actors: Sequence[Dict]) -> Dict:
        """[ego, *others] dicts -> the reference's batched state arrays.

        Each actor dict: position [x, y(, z)], yaw (rad), velocity [vx, vy],
        extent (half-length, half-width), and optional id/type/color/
        pitch/roll."""
        def col(key, default):
            return [[a.get(key, default) for a in actors]]

        return {
            "pos": [[list(map(float, a["position"][:2])) for a in actors]],
            "yaw": [[[float(a.get("yaw", 0.0))] for a in actors]],
            "vel": [[list(map(float, a.get("velocity", (0.0, 0.0))[:2]))
                     for a in actors]],
            "extent": [[_corners(a.get("extent", (2.45, 1.0)))
                        for a in actors]],
            "id": col("id", 0),
            "type": col("type", "vehicle"),
            "color": col("color", "0,0,0"),
            "height": [[[float(a["position"][2])
                         if len(a.get("position", [])) > 2 else 0.0]
                        for a in actors]],
            "pitch": col("pitch", 0.0),
            "roll": col("roll", 0.0),
        }

    def log(self, ego: Dict, actors: Sequence[Dict] = (),
            lights: Sequence[Dict] = (), control: Optional[Dict] = None,
            adv_controls: Sequence[Dict] = ()) -> None:
        """One simulation tick. `ego`/`actors`: see _actor_state. `lights`:
        {'position', 'yaw', 'state' (0 red / 1 yellow), 'extent'};
        green lights are not logged (reference logs only non-green)."""
        self.tick += 1
        if (self.tick - 1) % self.log_every_n != 0:
            return
        ego_pos = np.asarray(ego["position"][:2], float)
        near = [a for a in actors
                if np.linalg.norm(np.asarray(a["position"][:2]) - ego_pos)
                < self.roi]
        self.states.append(self._actor_state([ego] + near))
        kept = [l for l in lights if int(l.get("state", -1)) in (0, 1)]
        self.lights.append({
            "pos": [[list(map(float, l["position"][:2])) for l in kept]],
            "yaw": [[[float(l.get("yaw", 0.0))] for l in kept]],
            "state": [[[int(l["state"])] for l in kept]],
            "extent": [[_corners(l.get("extent", (1.5, 1.5)))
                        for l in kept]],
        } if kept else {"pos": [], "yaw": [], "state": [], "extent": []})
        if self.route is not None:
            self.route_boxes.append(route_as_boxes(
                self.route, ego_pos, ego.get("extent", (2.45, 1.0)),
                self.rdp_epsilon, self.roi))
        else:
            self.route_boxes.append({"pos": [], "yaw": [], "id": [],
                                     "extent": []})
        if control is not None:
            self.ego_actions.append({
                "steer": [[[float(control.get("steer", 0.0))]]],
                "throttle": [[[float(control.get("throttle", 0.0))]]],
                "brake": [[[float(control.get("brake", 0.0))]]],
            })
        self.adv_actions.append({
            "steer": [[[float(c.get("steer", 0.0))] for c in adv_controls]],
            "throttle": [[[float(c.get("throttle", 0.0))]
                          for c in adv_controls]],
            "brake": [[[float(c.get("brake", 0.0))] for c in adv_controls]],
        } if adv_controls else {"steer": [], "throttle": [], "brake": []})

    def dump(self, infractions: Optional[Dict] = None) -> Optional[str]:
        """Write `records.json.gz` in the reference layout
        (scenario_logger.py:497-535; `infractions` is our addition so the
        replay tooling can locate infraction frames without the separate
        leaderboard result JSON)."""
        if self.save_path is None:
            return None
        os.makedirs(self.save_path, exist_ok=True)
        path = os.path.join(self.save_path, "records.json.gz")
        record = {
            "meta_data": {"index": self.route_index, "town": self.town},
            "states": self.states,
            "lights": self.lights,
            "route": self.route_boxes,
            "ego_actions": self.ego_actions,
            "adv_actions": self.adv_actions,
            "infractions": infractions or {},
        }
        with gzip.open(path, "wt", encoding="utf-8") as f:
            json.dump(record, f)
        return path


# -- replay rendering -------------------------------------------------------

def _draw_box(ax, pos, yaw, corners, color, alpha=1.0, fill=True):
    from matplotlib.patches import Polygon
    corners = np.asarray(corners, float)          # [[ey, ex], ...] layout
    local = np.stack([corners[:, 1], corners[:, 0]], 1)   # -> (x, y)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    world = local @ rot.T + np.asarray(pos, float)
    ax.add_patch(Polygon(world, closed=True, facecolor=color if fill else
                         "none", edgecolor=color, alpha=alpha, lw=1.0))


_LIGHT_COLORS = {0: "red", 1: "gold", -1: "gray"}


def render_replay_frames(record_path: str, out_dir: str,
                         every_n: int = 1, roi: float = 40.0,
                         max_frames: Optional[int] = None) -> List[str]:
    """Record -> per-tick BEV PNG frames (ego-centered, north-up): route
    boxes gray, ego white-on-black, others blue, lights by state. These are
    the frames `make_infraction_gifs` assembles (the reference renders its
    camera `viz` frames during the run; ours replays from the record, so
    failure analysis needs no re-simulation)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with gzip.open(record_path, "rt") as f:
        rec = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    states = rec["states"]
    n = len(states) if max_frames is None else min(len(states), max_frames)
    for t in range(0, n, every_n):
        st = states[t]
        if not st.get("pos"):
            continue
        pos = np.asarray(st["pos"][0], float)
        yaw = np.asarray(st["yaw"][0], float).reshape(-1)
        ext = st["extent"][0]
        ego = pos[0]
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.set_facecolor("black")
        route = rec.get("route", [])
        if t < len(route) and route[t].get("pos"):
            rpos = np.asarray(route[t]["pos"][0], float)
            ryaw = np.asarray(route[t]["yaw"][0], float).reshape(-1)
            for i in range(len(rpos)):
                _draw_box(ax, rpos[i], ryaw[i], route[t]["extent"][0][i],
                          "dimgray", alpha=0.6)
        lights = rec.get("lights", [])
        if t < len(lights) and lights[t].get("pos"):
            lpos = np.asarray(lights[t]["pos"][0], float)
            lyaw = np.asarray(lights[t]["yaw"][0], float).reshape(-1)
            lstate = np.asarray(lights[t]["state"][0], int).reshape(-1)
            for i in range(len(lpos)):
                _draw_box(ax, lpos[i], lyaw[i], lights[t]["extent"][0][i],
                          _LIGHT_COLORS.get(int(lstate[i]), "gray"),
                          alpha=0.5)
        for i in range(1, len(pos)):
            _draw_box(ax, pos[i], yaw[i], ext[i], "deepskyblue")
        _draw_box(ax, ego, yaw[0], ext[0], "white")
        ax.set_xlim(ego[0] - roi, ego[0] + roi)
        ax.set_ylim(ego[1] - roi, ego[1] + roi)
        ax.set_aspect("equal")
        ax.set_title(f"tick {t}", color="black")
        path = os.path.join(out_dir, f"{t:04d}.png")
        fig.savefig(path, dpi=80, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths


def make_infraction_gifs(result_json: str, frames_dir: str, out_dir: str,
                         window: int = 50,
                         inspect: Optional[Sequence[str]] = None
                         ) -> List[str]:
    """Reference `tools/infraction_gifs.py`: for each infraction whose
    message carries "at Frame: N", collect frames N-window..N+window from
    `frames_dir` and write `<out_dir>/<infraction>/<route>_<i>.gif`."""
    from PIL import Image

    inspect = list(inspect) if inspect is not None else [
        "yield_emergency_vehicle_infractions", "collisions_pedestrian",
        "collisions_vehicle", "collisions_layout", "red_light",
        "stop_infraction", "scenario_timeouts", "outside_route_lanes",
        "vehicle_blocked", "route_dev",
    ]
    opener = gzip.open if result_json.endswith(".gz") else open
    with opener(result_json, "rt") as f:
        res = json.load(f)
    records = res.get("_checkpoint", {}).get("records", [res])
    available = set(os.listdir(frames_dir)) if os.path.isdir(frames_dir) \
        else set()
    out_paths = []
    for rec in records:
        route_idx = str(rec.get("route_id", "0")).replace("/", "_")
        for name in inspect:
            events = rec.get("infractions", {}).get(name, [])
            for i, ev in enumerate(events):
                msg = ev if isinstance(ev, str) else str(ev)
                if "at Frame: " not in msg:
                    continue
                frame = int(float(msg.split("at Frame: ")[-1].split()[0]))
                frames = []
                for t in range(frame - window, frame + window + 1):
                    for cand in (f"{t:04d}.png", f"{t}.png"):
                        if cand in available:
                            frames.append(os.path.join(frames_dir, cand))
                            break
                if not frames:
                    continue
                os.makedirs(os.path.join(out_dir, name), exist_ok=True)
                images = [Image.open(p).convert("P") for p in frames]
                gif = os.path.join(out_dir, name, f"{route_idx}_{i}.gif")
                images[0].save(gif, save_all=True,
                               append_images=images[1:], duration=500,
                               loop=0)
                out_paths.append(gif)
    return out_paths


def render_replay(record_path: str, out_path: str,
                  window: int = 100) -> str:
    """Single-figure trajectory summary of a recorded scenario (kept for
    quick inspection; `render_replay_frames` is the per-tick renderer)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with gzip.open(record_path, "rt") as f:
        rec = json.load(f)
    fig, ax = plt.subplots(figsize=(8, 8))
    ego_xy, other_xy = [], []
    for s in rec["states"]:
        if not s.get("pos"):
            continue
        pos = np.asarray(s["pos"][0], float)
        ego_xy.append(pos[0])
        other_xy.extend(pos[1:])
    if ego_xy:
        ego_xy = np.asarray(ego_xy)
        ax.plot(ego_xy[:, 0], ego_xy[:, 1], "b-", lw=2, label="ego")
        ax.scatter(*ego_xy[-1], c="b", s=60, marker="s")
    if other_xy:
        other_xy = np.asarray(other_xy)
        ax.scatter(other_xy[:, 0], other_xy[:, 1], c="r", s=8,
                   label="actors")
    route = rec.get("route", [])
    for t in range(0, len(route), max(len(route) // 5, 1)):
        if route[t].get("pos"):
            rpos = np.asarray(route[t]["pos"][0], float)
            ax.plot(rpos[:, 0], rpos[:, 1], "k--", lw=1)
    ax.legend()
    ax.set_aspect("equal")
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


def main(argv=None) -> None:
    """CLI (<- reference tools/infraction_gifs.py):

        python -m simlingo_tpu_torch.agent.scenario_logger gifs <result_json> \
            --records <dir of records.json.gz> --out <gif dir>
        python -m simlingo_tpu_torch.agent.scenario_logger replay <record.json.gz> \
            --out replay.png [--frames-dir DIR]
    """
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("cmd", choices=["gifs", "replay"])
    ap.add_argument("path", help="result json (gifs) or record (replay)")
    ap.add_argument("--records", default=None,
                    help="gifs: directory holding the ScenarioLogger "
                         "records to render frames from")
    ap.add_argument("--frames-dir", default=None,
                    help="pre-rendered frames dir (skips replay rendering)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--window", type=int, default=50)
    args = ap.parse_args(argv)

    if args.cmd == "replay":
        print(render_replay(args.path, args.out))
        return
    frames_dir = args.frames_dir
    if frames_dir is None:
        import glob as _glob
        frames_dir = os.path.join(args.out, "_frames")
        recs = sorted(_glob.glob(os.path.join(args.records or ".",
                                              "**", "records*.json.gz"),
                                 recursive=True))
        for rec in recs:
            render_replay_frames(rec, frames_dir)
    gifs = make_infraction_gifs(args.path, frames_dir, args.out,
                                window=args.window)
    for g in gifs:
        print(g)
    print(f"{len(gifs)} infraction gifs -> {args.out}")


if __name__ == "__main__":
    main()

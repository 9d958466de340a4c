"""Frame bucketing for balanced training sampling.

Copy of `simlingo_tpu/labels/buckets.py`.

Behavioral counterpart of reference
`dataset_generation/data_buckets/carla_get_buckets.py:326-470`: classify each
frame into scenario buckets (target-speed bins, lateral-control bins,
acceleration bins, start-from-stop, leading object, junction/red/green light,
changed route, hazards, brake, stop sign, parking lane) and write
`buckets_paths.pkl` mapping bucket -> list of measurement file paths.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from simlingo_tpu_torch.data import measurements as M
from simlingo_tpu_torch.data.index import build_index

TARGET_SPEED_BINS = [0.5, 5, 10, 15, 20, 25, 1000000]
LATERAL_CONTROL_BINS = [0.1, 1, 2, 5, 1000000]
ACCELERATION_BINS = [-40, -20, -5, -1, 1, 5, 20, 40, 1000000]


def classify_frame(current: Dict, waypoints: np.ndarray,
                   future_speeds: Optional[Sequence[float]] = None,
                   measurement_path: str = "") -> List[str]:
    """Bucket names for one frame given its measurement + waypoint labels."""
    buckets: List[str] = []

    speed_limit = current.get("speed_limit")
    if speed_limit is not None:
        buckets.append(f"speed_limit_{speed_limit}")

    target_speed = current.get("target_speed", 0.0)
    for b in TARGET_SPEED_BINS:
        if target_speed < b:
            buckets.append(f"target_speed_{b}")
            break

    lateral_control = float(np.abs(np.mean(waypoints[:, 1])))
    for b in LATERAL_CONTROL_BINS:
        if lateral_control < b:
            buckets.append(f"lateral_control_{b}")
            break

    if current.get("speed", 0.0) < 0.5 and target_speed > 0.8:
        buckets.append("start_from_stop")

    if future_speeds is not None and len(future_speeds) >= 2:
        # mean acceleration over the first ~1 s (4 Hz labels)
        dv = np.diff(np.asarray(future_speeds[:5], float))
        accel = float(np.mean(dv) / 0.25) if len(dv) else 0.0
        for b in ACCELERATION_BINS:
            if accel < b:
                buckets.append(f"acceleration_{b}")
                break

    leading = current.get("speed_reduced_by_obj_type")
    dist = current.get("speed_reduced_by_obj_distance")
    if leading is not None and dist is not None and dist < 30:
        kind = leading.split(".")[0]
        if kind in ("vehicle", "walker"):
            if dist < 20:
                buckets.append(f"leading_object_{kind}")
        else:
            buckets.append(f"leading_object_{leading}")

    if current.get("junction"):
        buckets.append("junction")
    if current.get("light_hazard"):
        buckets.append("red_light")
    if current.get("changed_route"):
        buckets.append("changed_route")
    if current.get("vehicle_hazard"):
        buckets.append("vehicle")
    if current.get("walker_hazard"):
        buckets.append("walker_hazard")
    if current.get("brake") or current.get("control_brake"):
        buckets.append("brake")
    if current.get("stop_sign_close"):
        buckets.append("stop_sign_close")
    if "parking_lane" in measurement_path and abs(lateral_control) > 0.2:
        buckets.append("parkinglane")
    return buckets


def generate_buckets(data_root: str, out_dir: str,
                     hist_len: int = 1, pred_len: int = 11,
                     splits: Sequence[str] = ("train",)) -> Dict[str, int]:
    """Scan the dataset and write buckets_paths.pkl (+ stats json)."""
    import json

    buckets: Dict[str, List[str]] = {}
    for split in splits:
        idx = build_index(data_root, split=split, use_town13=False,
                          hist_len=hist_len, pred_len=pred_len)
        for i in range(len(idx)):
            route_dir = idx.route_dir(i)
            frame = int(idx.frame[i])
            loaded, current, cur_path = M.load_measurement_window(
                route_dir, frame, hist_len, pred_len)
            wls = M.waypoints_labels(loaded, hist_len)
            future_speeds = [m.get("speed", 0.0) for m in loaded]
            names = classify_frame(current, wls["waypoints"], future_speeds,
                                   cur_path)
            for name in names:
                buckets.setdefault(name, []).append(cur_path)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "buckets_paths.pkl"), "wb") as f:
        pickle.dump(buckets, f)
    stats = {k: len(v) for k, v in buckets.items()}
    with open(os.path.join(out_dir, "buckets_stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    return stats


def main(argv=None) -> None:
    """CLI (<- reference data_buckets/carla_get_buckets.py):

        python -m simlingo_tpu_torch.labels.buckets <data_root> [--out DIR]
    """
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("data_root")
    ap.add_argument("--out", default=None,
                    help="output dir (default <data_root>/bucketsv2_simlingo)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.data_root, "bucketsv2_simlingo")
    stats = generate_buckets(args.data_root, out)
    for k in sorted(stats):
        print(f"{k:<44s} {stats[k]:>7d}")
    print(f"-> {out}")


if __name__ == "__main__":
    main()

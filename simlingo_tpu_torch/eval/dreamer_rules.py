"""Dreamer instruction-following success rules.

Copy of `simlingo_tpu/eval/dreamer_rules.py` (numpy only).

Behavioral counterpart of reference `DrivingModel.on_predict_epoch_end`
(models/driving.py:486-705): rule-based per-mode success checks on the
predicted waypoints/route vs the instructed ("new") and original expert
trajectories:

  stop         -- min predicted speed < 0.1 m/s
  slower       -- fitted speed slope < -0.05 * current_speed
  faster       -- fitted speed slope > +0.05 * current_speed
  target_speed -- desired end speed within [0.8, 1.2] x instructed/target
  lane_change  -- final route point closer (FDE) to instructed than original
  crash        -- route ADE closer to instructed than original (or, when the
                  two are near-identical, ADE < 1 m with plausible speeds)
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

WP_FREQ = 5
CARLA_FPS = 20
WP_DT = WP_FREQ / CARLA_FPS   # 0.25 s between waypoints


def desired_end_speed(wps: np.ndarray) -> float:
    one_second = int(CARLA_FPS // WP_FREQ)
    half_second = one_second // 2
    return float(np.linalg.norm(wps[-1 - half_second] - wps[-1]) * 2.0)


def speeds_from_waypoints(wps: np.ndarray) -> np.ndarray:
    wps_zero = np.concatenate([np.zeros((1, 2)), np.asarray(wps)], axis=0)
    seg = np.linalg.norm(np.diff(wps_zero, axis=0), axis=1)
    return seg / WP_DT


def speed_slope(wps: np.ndarray) -> float:
    speeds = speeds_from_waypoints(wps)
    x = np.arange(len(speeds)) * WP_DT
    slope, _ = np.polyfit(x, speeds, 1)
    return float(slope)


def evaluate_sample(mode: str,
                    pred_wps: np.ndarray, pred_route: np.ndarray,
                    org_wps: np.ndarray, org_route: np.ndarray,
                    new_wps: np.ndarray, new_route: np.ndarray,
                    current_speed: float,
                    target_speed: Optional[float] = None) -> Optional[bool]:
    pred_wps = np.asarray(pred_wps, np.float64)
    pred_route = np.asarray(pred_route, np.float64)
    org_wps = np.asarray(org_wps, np.float64)
    org_route = np.asarray(org_route, np.float64)
    new_wps = np.asarray(new_wps, np.float64)
    new_route = np.asarray(new_route, np.float64)

    if mode == "stop":
        return bool(np.min(speeds_from_waypoints(pred_wps)) < 0.1)
    if mode == "slower":
        return bool(speed_slope(pred_wps) < -0.05 * current_speed)
    if mode == "faster":
        return bool(speed_slope(pred_wps) > 0.05 * current_speed)
    if mode == "target_speed":
        des = desired_end_speed(pred_wps)
        des_instr = desired_end_speed(new_wps)
        ok_instr = 0.8 * des_instr < des < 1.2 * des_instr
        ok_target = (target_speed is not None
                     and 0.8 * target_speed < des < 1.2 * target_speed)
        return bool(ok_instr or ok_target)
    if mode == "lane_change":
        fde_org = np.linalg.norm(pred_route[-1] - org_route[-1])
        fde_new = np.linalg.norm(pred_route[-1] - new_route[-1])
        return bool(fde_new < fde_org)
    if mode == "crash":
        n = min(len(pred_route), len(org_route), len(new_route))
        ade_org_new = np.mean(np.linalg.norm(org_route[:n] - new_route[:n],
                                             axis=-1))
        ade_pred_org = np.mean(np.linalg.norm(pred_route[:n] - org_route[:n],
                                              axis=-1))
        ade_pred_new = np.mean(np.linalg.norm(pred_route[:n] - new_route[:n],
                                              axis=-1))
        if ade_org_new > 1.0:
            return bool(ade_pred_new < ade_pred_org)
        pred_speeds = speeds_from_waypoints(pred_wps)
        new_speeds = speeds_from_waypoints(new_wps)
        speed_ok = (np.mean(pred_speeds) < 1.3 * np.mean(new_speeds)
                    or np.mean(pred_speeds) > 0.7 * np.mean(new_speeds))
        return bool(ade_pred_new < 1.0 and speed_ok)
    return None


def aggregate(results: List[Dict]) -> Dict[str, float]:
    """results: [{'mode', 'success', 'allowed'}] -> summary like the
    reference's dreamer_results json."""
    out: Dict[str, float] = {}
    by_mode: Dict[str, List[bool]] = {}
    allok = []
    for r in results:
        if r["success"] is None:
            continue
        by_mode.setdefault(r["mode"], []).append(r["success"])
        allok.append(r["success"])
    out["success_rate_total"] = float(np.mean(allok)) if allok else 0.0
    for mode, vals in by_mode.items():
        out[f"success_rate_{mode}"] = float(np.mean(vals))
    out["num_samples"] = len(allok)
    return out

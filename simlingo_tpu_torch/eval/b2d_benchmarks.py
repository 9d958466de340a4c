"""Bench2Drive ability + efficiency/smoothness benchmarks.

Copy of `simlingo_tpu/eval/b2d_benchmarks.py`.

Behavioral counterparts of
`Bench2Drive/tools/ability_benchmark.py` (per-driving-ability success
rates over the scenario-type -> ability map, success = route Completed
with no significant infraction, :33-88,160-171) and
`Bench2Drive/tools/efficiency_smoothness_benchmark.py` (driving
efficiency = mean ego-speed %% from min-speed infractions :330-341;
smoothness = fraction of 100-step segments whose Savitzky-Golay-filtered
kinematics stay inside six human-comfort bounds :29-47,132-236).

Consumes leaderboard-format result JSONs (CARLA or microsim) plus
per-route metric_info.json files in the reference schema
({frame: {acceleration, angular_velocity, forward_vector, right_vector,
location, rotation}}); the microsim's RunRecorder writes that schema.

CLI:
  python -m simlingo_tpu_torch.eval.b2d_benchmarks --results merged.json \
      --metric-dir records/ [--route-scenarios scenarios.json]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# scenario-type -> ability map (ability_benchmark.py:33-60, verbatim set)
ABILITIES: Dict[str, List[str]] = {
    "Overtaking": [
        "Accident", "AccidentTwoWays", "ConstructionObstacle",
        "ConstructionObstacleTwoWays", "HazardAtSideLaneTwoWays",
        "HazardAtSideLane", "ParkedObstacleTwoWays", "ParkedObstacle",
        "VehicleOpensDoorTwoWays"],
    "Merging": [
        "CrossingBicycleFlow", "EnterActorFlow", "HighwayExit",
        "InterurbanActorFlow", "HighwayCutIn",
        "InterurbanAdvancedActorFlow", "MergerIntoSlowTrafficV2",
        "MergerIntoSlowTraffic", "NonSignalizedJunctionLeftTurn",
        "NonSignalizedJunctionRightTurn",
        "NonSignalizedJunctionLeftTurnEnterFlow", "ParkingExit",
        "SequentialLaneChange", "SignalizedJunctionLeftTurn",
        "SignalizedJunctionRightTurn",
        "SignalizedJunctionLeftTurnEnterFlow"],
    "Emergency_Brake": [
        "BlockedIntersection", "DynamicObjectCrossing", "HardBreakRoute",
        "OppositeVehicleTakingPriority", "OppositeVehicleRunningRedLight",
        "ParkingCutIn", "PedestrianCrossing", "ParkingCrossingPedestrian",
        "StaticCutIn", "VehicleTurningRoute",
        "VehicleTurningRoutePedestrian", "ControlLoss"],
    "Give_Way": ["InvadingTurn", "YieldToEmergencyVehicle"],
    "Traffic_Signs": [
        "BlockedIntersection", "OppositeVehicleTakingPriority",
        "OppositeVehicleRunningRedLight", "PedestrianCrossing",
        "VehicleTurningRoute", "VehicleTurningRoutePedestrian",
        "EnterActorFlow", "CrossingBicycleFlow",
        "NonSignalizedJunctionLeftTurn", "NonSignalizedJunctionRightTurn",
        "NonSignalizedJunctionLeftTurnEnterFlow",
        "SignalizedJunctionLeftTurn", "SignalizedJunctionRightTurn",
        "SignalizedJunctionLeftTurnEnterFlow", "T_Junction",
        "VanillaNonSignalizedTurn",
        "VanillaSignalizedTurnEncounterGreenLight",
        "VanillaSignalizedTurnEncounterRedLight",
        "VanillaNonSignalizedTurnEncounterStopsign"],
}

# comfort thresholds (efficiency_smoothness_benchmark.py:29-47,
# human-driving-study bounds)
MAX_ABS_MAG_JERK = 8.37       # m/s^3
MAX_ABS_LAT_ACCEL = 4.89      # m/s^2
MAX_LON_ACCEL = 2.40          # m/s^2
MIN_LON_ACCEL = -4.05         # m/s^2
MAX_ABS_YAW_ACCEL = 1.93      # rad/s^2
MAX_ABS_YAW_RATE = 0.95       # rad/s
MAX_ABS_LON_JERK = 4.13       # m/s^3


# ---------------------------------------------------------------------------
# ability benchmark
# ---------------------------------------------------------------------------

def has_significant_infraction(record: Dict) -> bool:
    """ability_benchmark.get_infraction_status: any infraction except
    min-speed counts."""
    for name, events in record.get("infractions", {}).items():
        if name == "min_speed_infractions":
            continue
        if len(events) > 0:
            return True
    return False


def route_success(record: Dict) -> bool:
    if record.get("status") not in ("Completed", "Perfect"):
        return False
    return not has_significant_infraction(record)


def scenario_of_route(record: Dict,
                      route_scenarios: Optional[Dict[str, str]] = None
                      ) -> Optional[str]:
    """Scenario type for a route record: explicit map wins; otherwise the
    microsim records it in meta (and MicroBench route ids name it)."""
    rid = str(record.get("route_id", ""))
    if route_scenarios:
        if rid in route_scenarios:
            return route_scenarios[rid]
        short = rid.split("_")[-1]
        if short in route_scenarios:
            return route_scenarios[short]
    return record.get("meta", {}).get("scenario_type")


def ability_benchmark(records: Sequence[Dict],
                      route_scenarios: Optional[Dict[str, str]] = None
                      ) -> Dict:
    """Per-ability and per-scenario success rates + crashed-route list
    (ability_benchmark.py main loop)."""
    ability_stat = {k: [0, 0] for k in ABILITIES}
    scenario_stat: Dict[str, List[int]] = {}
    crashed: List[str] = []
    for record in records:
        scenario = scenario_of_route(record, route_scenarios)
        # crash surfacing must not depend on scenario resolution -- a
        # crashed route with no scenario_type is the one to report
        if record.get("status") in ("Failed", "Crashed",
                                    "Failed - Simulation crashed",
                                    "Failed - Agent crashed"):
            crashed.append(str(record.get("route_id")))
        if scenario is None:
            continue
        ok = route_success(record)
        for ability, scenarios in ABILITIES.items():
            if scenario in scenarios:
                ability_stat[ability][1] += 1
                ability_stat[ability][0] += int(ok)
        scenario_stat.setdefault(scenario, [0, 0])
        scenario_stat[scenario][1] += 1
        scenario_stat[scenario][0] += int(ok)
    out = {
        "ability": {k: (100.0 * s / t if t else None)
                    for k, (s, t) in ability_stat.items()},
        "ability_counts": {k: tuple(v) for k, v in ability_stat.items()},
        "scenario_success": {k: 100.0 * s / t
                             for k, (s, t) in scenario_stat.items()},
        "crashed_routes": crashed,
    }
    rates = [v for v in out["ability"].values() if v is not None]
    out["ability_mean"] = sum(rates) / len(rates) if rates else None
    return out


# ---------------------------------------------------------------------------
# efficiency + smoothness
# ---------------------------------------------------------------------------

def driving_efficiency(records: Sequence[Dict]) -> Optional[float]:
    """Mean ego-speed-vs-traffic percentage from min-speed infraction
    messages (efficiency_smoothness_benchmark.py:330-341)."""
    per_route = []
    for record in records:
        vals = []
        for msg in record.get("infractions", {}).get(
                "min_speed_infractions", []):
            m = re.search(r"\b\d+\.?\d*%", str(msg))
            if not m:
                continue
            v = float(m.group().rstrip("%"))
            if v <= 1000:
                vals.append(v)
        if vals:
            per_route.append(sum(vals) / len(vals))
    return sum(per_route) / len(per_route) if per_route else None


def _phase_unwrap(headings: np.ndarray) -> np.ndarray:
    two_pi = 2.0 * np.pi
    adjustments = np.zeros_like(headings)
    adjustments[1:] = np.cumsum(np.round(np.diff(headings) / two_pi))
    return headings - two_pi * adjustments


def comfort_ok(acceleration: np.ndarray, yaw_rate: np.ndarray,
               forward: np.ndarray, right: np.ndarray,
               dt: float = 0.1, window: int = 7,
               poly_order: int = 2) -> bool:
    """One segment's pass/fail against all six comfort bounds
    (compute_comfort_metric :132-236; yaw acceleration computed as a real
    derivative -- the reference filters yaw rate twice without deriv)."""
    from scipy.signal import savgol_filter

    n = len(acceleration)
    window = min(window, n)
    if window <= poly_order:
        return True                      # too short to judge
    acc2d = np.asarray(acceleration, float)[:, :2]
    fwd2d = np.asarray(forward, float)[:, :2]
    right2d = np.asarray(right, float)[:, :2]
    # yaw_rate is a RATE (rad/s), not an angle: no phase unwrapping (the
    # reference unwraps it like a heading, which hides >pi rad/s spikes)
    yaw_rate = np.asarray(yaw_rate, float)

    lon = savgol_filter(np.einsum("ij,ij->i", acc2d, fwd2d),
                        window, poly_order)
    lat = savgol_filter(np.einsum("ij,ij->i", acc2d, right2d),
                        window, poly_order)
    mag = savgol_filter(np.hypot(acc2d[:, 0], acc2d[:, 1]),
                        window, poly_order)
    yr = savgol_filter(yaw_rate, window, poly_order)
    ya = savgol_filter(yaw_rate, window, poly_order, deriv=1, delta=dt)
    mag_jerk = savgol_filter(mag, window, poly_order, deriv=1, delta=dt)
    lon_jerk = savgol_filter(lon, window, poly_order, deriv=1, delta=dt)

    return bool(
        (lon > MIN_LON_ACCEL).all() and (lon < MAX_LON_ACCEL).all()
        and (np.abs(lat) < MAX_ABS_LAT_ACCEL).all()
        and (np.abs(mag_jerk) < MAX_ABS_MAG_JERK).all()
        and (np.abs(lon_jerk) < MAX_ABS_LON_JERK).all()
        and (np.abs(ya) < MAX_ABS_YAW_ACCEL).all()
        and (np.abs(yr) < MAX_ABS_YAW_RATE).all())


def smoothness(metric_info: Dict, dt: float = 0.1,
               segment: int = 100) -> float:
    """Fraction of `segment`-step chunks passing all comfort bounds
    (seg_compute_comfort_metric)."""
    frames = sorted(metric_info.keys(), key=lambda k: int(k))
    acc = np.asarray([metric_info[f]["acceleration"] for f in frames],
                     float)
    ang = np.asarray([metric_info[f]["angular_velocity"] for f in frames],
                     float)
    fwd = np.asarray([metric_info[f]["forward_vector"] for f in frames],
                     float)
    right = np.asarray([metric_info[f]["right_vector"] for f in frames],
                       float)
    if len(acc) < 4:
        return 1.0
    results = []
    for i in range(0, len(acc), segment):
        sl = slice(i, min(i + segment, len(acc)))
        if sl.stop - sl.start < 4:
            continue
        results.append(comfort_ok(acc[sl], ang[sl, 2], fwd[sl],
                                  right[sl], dt=dt))
    return float(np.mean(results)) if results else 1.0


def metric_info_from_states(positions: np.ndarray, yaws: np.ndarray,
                            speeds: np.ndarray, dt: float) -> Dict:
    """Derive the reference metric_info schema from recorded ego states
    (microsim ScenarioLogger records / replayed routes): acceleration by
    finite-differencing the velocity vector, angular velocity from yaw."""
    positions = np.asarray(positions, float)[:, :2]
    yaws = _phase_unwrap(np.asarray(yaws, float))
    speeds = np.asarray(speeds, float)
    vel = speeds[:, None] * np.stack([np.cos(yaws), np.sin(yaws)], 1)
    acc = np.zeros_like(vel)
    acc[1:] = np.diff(vel, axis=0) / dt
    wz = np.zeros_like(yaws)
    wz[1:] = np.diff(yaws) / dt
    out = {}
    for i in range(len(positions)):
        c, s = np.cos(yaws[i]), np.sin(yaws[i])
        out[str(i)] = {
            "acceleration": [float(acc[i, 0]), float(acc[i, 1]), 0.0],
            "angular_velocity": [0.0, 0.0, float(wz[i])],
            "forward_vector": [float(c), float(s), 0.0],
            "right_vector": [float(s), float(-c), 0.0],
            "location": [float(positions[i, 0]), float(positions[i, 1]),
                         0.0],
            "rotation": [0.0, 0.0, float(np.degrees(yaws[i]))],
        }
    return out


def metric_info_from_record(record_path: str, dt: float = 0.05) -> Dict:
    """Ego kinematics out of a ScenarioLogger records.json.gz (the ego is
    the first actor of every logged state)."""
    with gzip.open(record_path, "rt") as f:
        rec = json.load(f)
    pos, yaw, speed = [], [], []
    for st in rec["states"]:
        # batched arrays: key[0] = actor list for the tick, [0][0] = ego
        if not st.get("pos") or not st["pos"][0]:
            continue
        pos.append(st["pos"][0][0][:2])
        yaw.append(float(np.asarray(st["yaw"][0][0],
                                    float).reshape(-1)[0]))
        v = np.asarray(st.get("vel", [[[0.0, 0.0]]])[0][0],
                       float).reshape(-1)
        speed.append(float(np.hypot(v[0], v[1])) if v.size >= 2
                     else float(v[0]))
    return metric_info_from_states(np.asarray(pos), np.asarray(yaw),
                                   np.asarray(speed), dt)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(
        description="Bench2Drive ability + efficiency/smoothness")
    ap.add_argument("--results", required=True,
                    help="leaderboard-format result JSON (merged)")
    ap.add_argument("--metric-dir", default=None,
                    help="dir of per-route metric_info.json or "
                         "records.json.gz (microsim --record output)")
    ap.add_argument("--route-scenarios", default=None,
                    help="JSON {route_id: scenario_type} (else read from "
                         "record meta)")
    ap.add_argument("--dt", type=float, default=0.05)
    args = ap.parse_args(argv)

    with open(args.results) as f:
        data = json.load(f)
    records = data.get("_checkpoint", {}).get("records", [data])
    route_scenarios = None
    if args.route_scenarios:
        with open(args.route_scenarios) as f:
            route_scenarios = json.load(f)

    out = ability_benchmark(records, route_scenarios)
    out["driving_efficiency"] = driving_efficiency(records)
    if args.metric_dir:
        scores = []
        for record in records:
            rid = str(record.get("route_id"))
            mi_path = os.path.join(args.metric_dir, rid,
                                   "metric_info.json")
            rec_path = os.path.join(args.metric_dir, rid,
                                    "records.json.gz")
            if os.path.exists(mi_path):
                with open(mi_path) as f:
                    mi = json.load(f)
            elif os.path.exists(rec_path):
                mi = metric_info_from_record(rec_path, dt=args.dt)
            else:
                continue
            scores.append(smoothness(mi, dt=args.dt))
        out["driving_smoothness"] = (float(np.mean(scores))
                                     if scores else None)
    print(json.dumps(out, indent=1, default=str))
    return out


if __name__ == "__main__":
    main()

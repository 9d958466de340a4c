"""Closed-loop driving-score computation + route-result aggregation.

Copy of `simlingo_tpu/eval/driving_score.py`.

Behavioral counterpart of:
  * the leaderboard StatisticsManager penalty table and score formula
    (Bench2Drive/leaderboard/leaderboard/utils/statistics_manager.py:21-53):
    driving score = route completion x PRODUCT(penalty ^ count), with the
    Bench2Drive variant ignoring min-speed and outside-route-lanes;
  * Bench2Drive/tools/merge_route_json.py:21-62: mean driving score and
    success rate over the 220-route benchmark;
  * tools/result_parser.py:26-39: normalized infractions per km.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Dict, List, Optional, Sequence

# statistics_manager.py PENALTY_VALUE_DICT (both leaderboard variants):
# fixed multiplicative penalties per counted event.
PENALTIES: Dict[str, float] = {
    "collisions_pedestrian": 0.50,
    "collisions_vehicle": 0.60,
    "collisions_layout": 0.65,
    "red_light": 0.70,
    "stop_infraction": 0.80,
    "scenario_timeouts": 0.70,
    "yield_emergency_vehicle_infractions": 0.70,
    # percentage-based (PENALTY_PERC_DICT) -- handled specially below:
    # min_speed is 'unused' in the Bench2Drive variant (factor 1.0);
    # outside_route_lanes multiplies (1 - pct/100) per event, pct taken
    # from the event message ("... (Y% of the completed route)").
    "min_speed_infractions": 1.0,
    "outside_route_lanes": 1.0,
}


def _event_penalty(name: str, events: Sequence) -> float:
    """Product of penalties for all events of one infraction type
    (Bench2Drive statistics_manager.py compute_route_statistics:
    PENALTY_VALUE_DICT events use a fixed factor per count;
    OUTSIDE_ROUTE_LANES is [0, 'increases'] => factor (1 - pct/100);
    MIN_SPEED is 'unused' => factor 1.0)."""
    if name == "outside_route_lanes":
        penalty = 1.0
        for e in events:
            vals = _floats(e)
            pct = vals[1] if len(vals) >= 2 else 0.0
            penalty *= max(0.0, 1.0 - pct / 100.0)
        return penalty
    return PENALTIES.get(name, 1.0) ** len(events)


def driving_score(route_completion: float,
                  infractions: Dict[str, Sequence]) -> float:
    """route completion in [0, 100] x product of per-event penalties."""
    score = route_completion
    for name, events in infractions.items():
        score *= _event_penalty(name, events)
    return score


def is_success(record: Dict) -> bool:
    """Bench2Drive success (merge_route_json.py:55-66): status Completed
    or Perfect AND no infractions other than min_speed_infractions.

    Records without a status field (bare score dicts) fall back to the
    score test (completion == 100 and composed == 100)."""
    status = record.get("status")
    if status is not None:
        if status not in ("Completed", "Perfect"):
            return False
        for name, events in record.get("infractions", {}).items():
            n = len(events) if isinstance(events, (list, tuple)) \
                else int(bool(events))
            if n > 0 and name != "min_speed_infractions":
                return False
        return True
    scores = record.get("scores", record)
    rc = scores.get("score_route", 0.0)
    ds = scores.get("score_composed", 0.0)
    return rc >= 100.0 and ds >= 100.0


def merge_route_results(result_files: Sequence[str]) -> Dict[str, float]:
    """Aggregate per-route result JSONs -> mean DS + success rate
    (Bench2Drive/tools/merge_route_json.py:21-62). Like the reference,
    records with status 'Failed - Agent crashed' are excluded from every
    aggregate (golden parity: tests/test_reference_goldens.py)."""
    scores: List[float] = []
    successes: List[bool] = []
    km = 0.0
    infraction_totals: Dict[str, int] = {}
    for path in result_files:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            rec = json.load(f)
        records = rec.get("_checkpoint", {}).get("records", [rec])
        for r in records:
            if r.get("status") == "Failed - Agent crashed":
                continue
            s = r.get("scores", r)
            scores.append(float(s.get("score_composed", 0.0)))
            successes.append(is_success(r))
            meters = r.get("meta", {}).get("route_length", 0.0)
            km += meters / 1000.0
            for name, events in r.get("infractions", {}).items():
                n = len(events) if isinstance(events, list) else int(events)
                infraction_totals[name] = infraction_totals.get(name, 0) + n
    n = max(len(scores), 1)
    out = {
        "driving_score": sum(scores) / n,
        "success_rate": 100.0 * sum(successes) / n,
        "num_routes": len(scores),
    }
    if km > 0:
        for name, cnt in infraction_totals.items():
            out[f"{name}_per_km"] = cnt / km
    return out


def merge_route_dir(results_dir: str) -> Dict[str, float]:
    files = sorted(glob.glob(os.path.join(results_dir, "*.json"))
                   + glob.glob(os.path.join(results_dir, "*.json.gz")))
    return merge_route_results(files)


def results_to_csv(result_files: Sequence[str], out_csv: str) -> str:
    """Per-route CSV report (reference tools/result_parser.py:26-39):
    route id, driving score, route completion, per-infraction counts,
    normalized infractions/km."""
    import csv

    rows: List[Dict] = []
    inf_names: set = set()
    for path in result_files:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            rec = json.load(f)
        records = rec.get("_checkpoint", {}).get("records", [rec])
        for r in records:
            s = r.get("scores", r)
            row = {
                "route": r.get("route_id", os.path.basename(path)),
                "driving_score": s.get("score_composed", 0.0),
                "route_completion": s.get("score_route", 0.0),
                "success": is_success(r),
                "route_length_m": r.get("meta", {}).get("route_length", 0.0),
            }
            for name, events in r.get("infractions", {}).items():
                n = len(events) if isinstance(events, list) else int(events)
                row[name] = n
                inf_names.add(name)
            rows.append(row)
    fields = ["route", "driving_score", "route_completion", "success",
              "route_length_m"] + sorted(inf_names)
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, restval=0)
        w.writeheader()
        for row in rows:
            w.writerow(row)
    return out_csv


# -- full result-parser depth (reference tools/result_parser.py) -----------

# result_parser.py:26-39: per-km EXPONENTIAL penalty bases (penalty^(inf/km))
_SCALE_FACTOR = 0.2
NORMALIZED_PENALTIES: Dict[str, float] = {
    "collisions_pedestrian": 0.5 * _SCALE_FACTOR,
    "collisions_vehicle": 0.6 * _SCALE_FACTOR,
    "collisions_layout": 0.65 * _SCALE_FACTOR,
    "red_light": 0.7 * _SCALE_FACTOR,
    "scenario_timeouts": 0.7 * _SCALE_FACTOR,
    "yield_emergency_vehicle_infractions": 0.7 * _SCALE_FACTOR,
    "stop_infraction": 0.8 * _SCALE_FACTOR,
}

INFRACTION_NAMES = [
    "collisions_layout", "collisions_pedestrian", "collisions_vehicle",
    "red_light", "stop_infraction", "outside_route_lanes",
    "min_speed_infractions", "yield_emergency_vehicle_infractions",
    "scenario_timeouts", "route_dev", "vehicle_blocked", "route_timeout",
]


def _min_speed_penalty(percentage: float) -> float:
    """result_parser.py:41-51: linear penalty toward 0.7 at 0% of the
    surrounding traffic's speed."""
    return 1 - (1 - 0.7) * (1 - percentage / 100.0)


def _outside_route_lanes_penalty(percentage: float) -> float:
    """result_parser.py:53-63: proportional penalty for % off-route."""
    return 1 - percentage / 100.0


def _floats(text: str) -> List[float]:
    import re
    return [float(x) for x in re.findall(r"\d+\.?\d*", str(text))]


def parse_route_record(record: Dict) -> Dict:
    """One leaderboard route record -> parsed metrics including the
    NORMALIZED driving score (result_parser.py:195-271): route completion x
    exponential per-km penalties for counted infractions x special-cased
    min-speed / outside-lane percentage penalties."""
    scores = record.get("scores", {})
    meta = record.get("meta", {})
    infractions = record.get("infractions", {})

    rc = float(scores.get("score_route", 0.0))
    route_km = float(meta.get("route_length", 0.0)) / 1000.0
    driven_km = (rc / 100.0) * route_km
    hours = float(meta.get("duration_game", 0.0)) / 3600.0

    local: Dict[str, float] = {}
    for name in INFRACTION_NAMES:
        events = infractions.get(name, [])
        if name == "outside_route_lanes":
            # message carries meters off-road first
            local[name] = (_floats(events[0])[0] / 1000.0) if events else 0.0
        elif name == "min_speed_infractions":
            if events:
                fracs = [min(1.0, max(0.0, _floats(e)[0] / 100.0))
                         for e in events]
                local[name] = 1.0 - sum(fracs) / len(fracs)
            else:
                local[name] = 0.0
        else:
            local[name] = float(len(events))

    penalty = 1.0
    for name, base in NORMALIZED_PENALTIES.items():
        if driven_km > 0.0 and local.get(name, 0.0) > 0.0:
            penalty *= base ** (local[name] / driven_km)
    for e in infractions.get("min_speed_infractions", []):
        penalty *= _min_speed_penalty(_floats(e)[0])
    for e in infractions.get("outside_route_lanes", []):
        vals = _floats(e)
        if len(vals) >= 2:
            penalty *= _outside_route_lanes_penalty(vals[1])

    return {
        "route": record.get("route_id", "?"),
        "town": meta.get("town", "?"),
        "status": record.get("status", ""),
        "DS": float(scores.get("score_composed", 0.0)),
        "RC": rc,
        "IS": float(scores.get("score_penalty", 1.0)),
        "NDS": rc * penalty,
        "NIS": penalty,
        "driven_km": driven_km,
        "hours": hours,
        "duration": float(meta.get("duration_game", 0.0)),
        "length": float(meta.get("route_length", 0.0)),
        "infractions": local,
    }


def parse_results(result_files: Sequence[str],
                  route_towns: Optional[Dict[str, str]] = None) -> Dict:
    """All route records -> totals + per-route/per-town aggregation
    (result_parser.py:286-408). Returns {'totals', 'per_route',
    'per_town', 'routes'}; totals include infractions normalized per km
    (percent-based ones in [0, 100])."""
    routes: List[Dict] = []
    for path in result_files:
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            rec = json.load(f)
        for r in rec.get("_checkpoint", {}).get("records", [rec]):
            parsed = parse_route_record(r)
            if route_towns:
                import re
                m = re.search(r"_(\d+)_", str(parsed["route"]))
                key = m.group(1) if m else str(parsed["route"])
                parsed["town"] = route_towns.get(key, parsed["town"])
            routes.append(parsed)
    n = max(len(routes), 1)
    total_km = sum(r["driven_km"] for r in routes)
    total_h = sum(r["hours"] for r in routes)

    inf_totals = {name: sum(r["infractions"].get(name, 0.0)
                            for r in routes) for name in INFRACTION_NAMES}
    inf_per_km = {}
    for name, value in inf_totals.items():
        if name == "min_speed_infractions":
            inf_per_km[name] = (value / n) * 100.0
        elif total_km > 0:
            per = value / total_km
            inf_per_km[name] = per * 100.0 \
                if name == "outside_route_lanes" else per
        else:
            inf_per_km[name] = 0.0

    totals = {
        "avg_driving_score": sum(r["DS"] for r in routes) / n,
        "avg_route_completion": sum(r["RC"] for r in routes) / n,
        "avg_infraction_penalty": sum(r["IS"] for r in routes) / n,
        "avg_normalized_ds": sum(r["NDS"] for r in routes) / n,
        "avg_normalized_is": sum(r["NIS"] for r in routes) / n,
        "avg_speed_kmh": total_km / total_h if total_h > 0 else 0.0,
        "total_km": total_km,
        "num_routes": len(routes),
        **{f"{k}_per_km": v for k, v in inf_per_km.items()},
    }

    def aggregate(key: str) -> Dict[str, Dict]:
        groups: Dict[str, List[Dict]] = {}
        for r in routes:
            groups.setdefault(str(r[key]), []).append(r)
        out = {}
        for g, rs in groups.items():
            m = len(rs)
            def stat(field):
                vals = [r[field] for r in rs]
                mean = sum(vals) / m
                std = (sum((v - mean) ** 2 for v in vals) / m) ** 0.5
                return mean, std
            out[g] = {
                "DS": stat("DS"), "RC": stat("RC"), "NDS": stat("NDS"),
                "duration": stat("duration"), "length": stat("length"),
                "infractions": {
                    name: (lambda vals: (sum(vals) / m,
                                         (sum((v - sum(vals) / m) ** 2
                                              for v in vals) / m) ** 0.5))(
                        [r["infractions"].get(name, 0.0) for r in rs])
                    for name in INFRACTION_NAMES},
            }
        return out

    return {"totals": totals, "per_route": aggregate("route"),
            "per_town": aggregate("town"), "routes": routes}


def write_result_csv(parsed: Dict, out_csv: str) -> str:
    """result_parser.py:410-467 CSV layout: the totals block, then
    mean/std aggregation tables per route and per town."""
    import csv

    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        for label, value in parsed["totals"].items():
            w.writerow([label, value])
        w.writerow([""])
        for filt in ("per_route", "per_town"):
            inf_cols = []
            for name in INFRACTION_NAMES:
                inf_cols += [f"{name} mean", f"{name} std"]
            w.writerow([filt.replace("per_", ""), "DS mean", "DS std",
                        "RC mean", "RC std", "NDS mean", "NDS std",
                        "duration mean", "duration std", "length mean",
                        "length std"] + inf_cols)
            for key in sorted(parsed[filt]):
                item = parsed[filt][key]
                row = [key]
                for field in ("DS", "RC", "NDS", "duration", "length"):
                    row += [item[field][0], item[field][1]]
                for name in INFRACTION_NAMES:
                    row += list(item["infractions"][name])
                w.writerow(row)
            w.writerow([""])
    return out_csv


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """CLI counterpart of the reference's two results scripts in one:

        python -m simlingo_tpu_torch.eval.driving_score <results_dir_or_files...>
            [--csv out.csv] [--parsed-csv parsed.csv]

    Prints the merged benchmark metrics (merge_route_json.py: mean DS /
    success rate over all routes) and optionally writes the per-route CSV
    (result_parser.py: normalized infractions/km)."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("paths", nargs="+",
                    help="result json/json.gz files or directories of them")
    ap.add_argument("--csv", default=None,
                    help="write the per-route CSV report here")
    ap.add_argument("--parsed-csv", default=None,
                    help="write the aggregated totals/per-town CSV here")
    args = ap.parse_args(argv)

    files: List[str] = []
    for p in args.paths:
        if os.path.isdir(p):
            files += sorted(glob.glob(os.path.join(p, "**", "*.json*"),
                                      recursive=True))
        else:
            files.append(p)
    files = [f for f in files if f.endswith((".json", ".json.gz"))]
    merged = merge_route_results(files)
    print(json.dumps(merged, indent=2, sort_keys=True))
    if args.csv:
        results_to_csv(files, args.csv)
        print(f"per-route CSV -> {args.csv}")
    if args.parsed_csv:
        write_result_csv(parse_results(files), args.parsed_csv)
        print(f"aggregated CSV -> {args.parsed_csv}")
    return merged


if __name__ == "__main__":
    main()

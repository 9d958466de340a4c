"""Dataset hygiene + route tooling.

Copy of `simlingo_tpu/labels/dataset_tools.py`.

Behavioral counterparts of reference `dataset_generation/*.py` utilities
(SURVEY.md section 2.7 "Route tooling" and section 4.6):
  * find/delete failed runs (missing or crashed results.json.gz)
    <- delete_failed_runs.py
  * find/delete routes with penalized infractions <- delete_infraction_routes.py
  * find defective label files (unreadable json.gz) <- delete_defect_jsons.py,
    tools/filter_broken_files.py
  * duplicate-route detection by route content hash
    <- filter_duplicate_routes.py
  * scenario-type balance report <- balance_scenarios.py
"""

from __future__ import annotations

import collections
import glob
import gzip
import hashlib
import json
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

from simlingo_tpu_torch.data.index import route_passes_quality_gate


def _route_dirs(data_root: str) -> List[str]:
    return sorted(glob.glob(os.path.join(data_root, "data", "simlingo",
                                         "*", "*", "*", "Town*")))


def find_failed_runs(data_root: str) -> List[str]:
    """Routes with no/corrupt results or a failing quality gate."""
    return [r for r in _route_dirs(data_root)
            if not route_passes_quality_gate(r)]


def delete_failed_runs(data_root: str, dry_run: bool = True) -> List[str]:
    failed = find_failed_runs(data_root)
    if not dry_run:
        for r in failed:
            shutil.rmtree(r, ignore_errors=True)
    return failed


def rename_failed_runs(data_root: str, undo: bool = False,
                       dry_run: bool = True) -> List[str]:
    """Mark failed runs with a FAILED_ directory prefix instead of deleting
    (reference delete_infraction_routes.py RENAME / UNDO_RENAMING modes --
    reversible quarantine; discovery globs match Town* so prefixed routes
    drop out of every index)."""
    moved: List[str] = []
    if undo:
        pattern = os.path.join(data_root, "data", "simlingo",
                               "*", "*", "*", "FAILED_Town*")
        for r in sorted(glob.glob(pattern)):
            dst = os.path.join(os.path.dirname(r),
                               os.path.basename(r)[len("FAILED_"):])
            moved.append(r)
            if not dry_run:
                os.rename(r, dst)
        return moved
    for r in find_failed_runs(data_root):
        dst = os.path.join(os.path.dirname(r),
                           "FAILED_" + os.path.basename(r))
        moved.append(r)
        if not dry_run:
            os.rename(r, dst)
    return moved


def count_frames(data_root: str) -> Dict[str, int]:
    """Per-subdir file counts over the dataset (reference
    count_json_gz_files.py): frames collected, labels generated."""
    counts: Dict[str, int] = collections.Counter()
    for route in _route_dirs(data_root):
        for sub in os.listdir(route):
            subdir = os.path.join(route, sub)
            if os.path.isdir(subdir):
                counts[sub] += len(os.listdir(subdir))
    return dict(counts)


def find_defect_jsons(data_root: str,
                      subdirs: Sequence[str] = ("measurements", "commentary",
                                                "vqa", "dreamer", "boxes")
                      ) -> List[str]:
    """Unreadable/corrupt .json.gz label files."""
    bad: List[str] = []
    for route in _route_dirs(data_root):
        for sub in subdirs:
            for path in glob.glob(os.path.join(route, sub, "*.json.gz")):
                try:
                    with gzip.open(path, "rt") as f:
                        json.load(f)
                except Exception:
                    bad.append(path)
    return bad


def delete_defect_jsons(data_root: str, dry_run: bool = True) -> List[str]:
    bad = find_defect_jsons(data_root)
    if not dry_run:
        for p in bad:
            os.remove(p)
    return bad


def route_content_hash(route_dir: str) -> Optional[str]:
    """Hash of the first measurement's route geometry -- duplicates of the
    same (route, scenario) replay hash equal."""
    path = os.path.join(route_dir, "measurements", "0000.json.gz")
    if not os.path.isfile(path):
        files = sorted(glob.glob(os.path.join(route_dir, "measurements",
                                              "*.json.gz")))
        if not files:
            return None
        path = files[0]
    try:
        with gzip.open(path, "rt") as f:
            m = json.load(f)
    except Exception:
        return None
    key = json.dumps({"route": m.get("route_original"),
                      "pos": m.get("pos_global")}, sort_keys=True)
    return hashlib.sha1(key.encode()).hexdigest()


def find_duplicate_routes(data_root: str) -> Dict[str, List[str]]:
    groups: Dict[str, List[str]] = collections.defaultdict(list)
    for r in _route_dirs(data_root):
        h = route_content_hash(r)
        if h:
            groups[h].append(r)
    return {h: rs for h, rs in groups.items() if len(rs) > 1}


def scenario_balance_report(data_root: str) -> Dict[str, int]:
    """Count routes per scenario type (scenario name encoded in the route
    dir name, e.g. Town12_Rep0_<scenario>_...)."""
    counts: Dict[str, int] = collections.defaultdict(int)
    for r in _route_dirs(data_root):
        name = os.path.basename(r)
        parts = name.split("_")
        scenario = parts[2] if len(parts) > 2 else "unknown"
        counts[scenario] += 1
    return dict(counts)


def upsample_plan(counts: Dict[str, int],
                  target: Optional[int] = None) -> Dict[str, int]:
    """How many extra copies per scenario to reach balance
    (<- balance_scenarios.py)."""
    if not counts:
        return {}
    target = target or max(counts.values())
    return {k: max(target - v, 0) for k, v in counts.items()}


def main(argv: Optional[Sequence[str]] = None) -> None:
    """One CLI for the reference's standalone hygiene scripts:

        python -m simlingo_tpu_torch.labels.dataset_tools <cmd> <data_root>

    cmd: failed (<- delete_failed_runs.py; --delete / --rename / --undo),
    defects (<- delete_defect_jsons.py; --delete), duplicates
    (<- filter_duplicate_routes.py), balance (<- balance_scenarios.py
    report + upsample plan), frames (<- count_json_gz_files.py).
    Default is always a dry-run report; destructive actions need flags."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("cmd", choices=["failed", "defects", "duplicates",
                                    "balance", "frames"])
    ap.add_argument("data_root")
    ap.add_argument("--delete", action="store_true",
                    help="actually delete (failed / defects)")
    ap.add_argument("--rename", action="store_true",
                    help="quarantine-rename failed routes to FAILED_*")
    ap.add_argument("--undo", action="store_true",
                    help="undo a previous quarantine rename")
    args = ap.parse_args(argv)

    if args.cmd == "failed":
        if args.rename or args.undo:
            moved = rename_failed_runs(args.data_root, undo=args.undo,
                                       dry_run=False)
            for r in moved:
                print(r)
            print(f"{len(moved)} routes "
                  f"{'restored' if args.undo else 'quarantined'}")
        else:
            routes = delete_failed_runs(args.data_root,
                                        dry_run=not args.delete)
            for r in routes:
                print(r)
            print(f"{len(routes)} failed routes"
                  + ("" if args.delete else " (dry run; --delete to remove)"))
    elif args.cmd == "defects":
        files = delete_defect_jsons(args.data_root, dry_run=not args.delete)
        for f in files:
            print(f)
        print(f"{len(files)} defective files"
              + ("" if args.delete else " (dry run; --delete to remove)"))
    elif args.cmd == "duplicates":
        dups = find_duplicate_routes(args.data_root)
        for h, routes in sorted(dups.items()):
            print(h, *routes)
        print(f"{len(dups)} duplicate groups")
    elif args.cmd == "balance":
        counts = scenario_balance_report(args.data_root)
        plan = upsample_plan(counts)
        for k in sorted(counts):
            print(f"{k:<40s} {counts[k]:>6d}  (+{plan[k]} to balance)")
    elif args.cmd == "frames":
        for k, v in sorted(count_frames(args.data_root).items()):
            print(f"{k:<60s} {v:>7d}")


if __name__ == "__main__":
    main()

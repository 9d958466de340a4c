#!/usr/bin/env python
"""Expert data collection and labelling for the PyTorch port.

Counterpart of `collect_dataset.py`, with the same command line: per-route
expert jobs (the in-repo microsim's expert, or DATAGEN leaderboard runs
with the port's data-collection agent), babysat with log-scanning
auto-cancel and resubmission and a live-tunable concurrency
(max_num_jobs.txt). Afterwards the port's label generators run over the
collected routes: commentary, VQA and dreamer labels in each route, then
the sampling buckets (`<save-root>/bucketsv2_simlingo/buckets_paths.pkl`,
which `configs/simlingo.yaml`'s `data.bucket_path` names).

    python collect_dataset_torch.py --microsim --save-root database/simlingo
    python collect_dataset_torch.py --routes-dir <xmls> --save-root database/simlingo
    python collect_dataset_torch.py --labels-only --save-root database/simlingo

Labelling runs on the host (numpy). Nothing here imports the JAX package.
"""

import argparse
import glob
import os
import time
from typing import Dict, List


def route_dirs(save_root: str) -> List[str]:
    """The collected routes under `save_root`, in the trainer's layout."""
    pattern = os.path.join(save_root, "data", "simlingo", "*", "*", "*", "Town*")
    return sorted(glob.glob(pattern))


def run_label_generation(save_root: str) -> Dict:
    """Commentary, VQA and dreamer labels for every route under
    `save_root`, then the buckets. Returns per route the ms each generator
    took and the files it wrote, and the buckets' assignments by class."""
    from simlingo_tpu_torch.labels import buckets, commentary, dreamer_gen, vqa

    routes = route_dirs(save_root)
    print(f"label generation over {len(routes)} routes")
    per_route = {}
    for r in routes:
        stats = {}
        for name, gen in (("commentary", commentary.generate_route_commentary),
                          ("vqa", vqa.generate_route_vqa),
                          ("dreamer", dreamer_gen.generate_route_dreamer)):
            t0 = time.perf_counter()
            gen(r)
            d = os.path.join(r, name)
            stats[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                           "files": len(os.listdir(d)) if os.path.isdir(d) else 0}
        per_route[r] = stats
        print(f"{os.path.basename(r)}: " + ", ".join(
            f"{k} {v['ms']:.1f} ms ({v['files']} files)" for k, v in stats.items()), flush=True)
    bucket_dir = os.path.join(save_root, "bucketsv2_simlingo")
    t0 = time.perf_counter()
    classes = buckets.generate_buckets(save_root, bucket_dir)
    buckets_ms = (time.perf_counter() - t0) * 1e3
    print(f"buckets: {len(classes)} classes, {sum(classes.values())} assignments "
          f"in {buckets_ms:.1f} ms")
    return {"routes": per_route, "bucket_dir": bucket_dir, "buckets": classes,
            "buckets_ms": buckets_ms}


def microsim_jobs(save_root: str, suite: str):
    """One babysat `simlingo_tpu_torch.sim.suite --agent expert --collect`
    job per route of the microsim suite."""
    from simlingo_tpu_torch.orchestration.babysitter import Job
    from simlingo_tpu_torch.sim.suite import SUITES
    collect_root = os.path.join(save_root, "data", "simlingo", "v1", "micro",
                                "routes_training")
    log_dir = os.path.join(save_root, "logs")
    result_dir = os.path.join(save_root, "microsim_results")
    os.makedirs(result_dir, exist_ok=True)
    jobs = []
    for spec in SUITES[suite]():
        rid = spec["route_id"]
        done = os.path.join(collect_root, f"Town12_{rid}", "results.json.gz")
        cmd = ["python", "-m", "simlingo_tpu_torch.sim.suite",
               "--suite", suite,
               "--agent", "expert", "--routes", rid,
               "--collect", collect_root,
               "--out", os.path.join(result_dir, f"{rid}.json")]
        jobs.append(Job(name=rid, cmd=cmd, done_file=done,
                        log_path=os.path.join(log_dir, f"{rid}.log")))
    return jobs


def carla_jobs(routes_dir: str, save_root: str, leaderboard: str,
               base_port: int, max_jobs: int):
    """One leaderboard run with the port's data agent per route XML."""
    from simlingo_tpu_torch.orchestration.babysitter import Job
    routes = sorted(glob.glob(os.path.join(routes_dir, "*.xml")))
    jobs = []
    log_dir = os.path.join(save_root, "logs")
    for i, route in enumerate(routes):
        name = os.path.splitext(os.path.basename(route))[0]
        save_path = os.path.join(save_root, "data", "simlingo",
                                 "v1", "local", "routes_training", name)
        port = base_port + 10 * (i % max(max_jobs, 1))
        cmd = [
            "python", leaderboard,
            f"--routes={route}",
            "--agent=simlingo_tpu_torch/agent/carla_data_agent.py",
            f"--checkpoint={save_path}/results.json.gz",
            f"--port={port}",
        ]
        env_done = os.path.join(save_path, "results.json.gz")
        jobs.append(Job(name=name, cmd=cmd, done_file=env_done,
                        log_path=os.path.join(log_dir, f"{name}.log")))
    return jobs


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--routes-dir", default=None)
    ap.add_argument("--save-root", required=True)
    ap.add_argument("--leaderboard",
                    default="leaderboard/leaderboard/leaderboard_evaluator.py")
    ap.add_argument("--max-jobs", type=int, default=4)
    ap.add_argument("--base-port", type=int, default=2000)
    ap.add_argument("--slurm", action="store_true")
    ap.add_argument("--labels-only", action="store_true")
    ap.add_argument("--microsim", action="store_true",
                    help="collect with the in-repo microsim (no CARLA): "
                         "one babysat job per MicroBench route")
    ap.add_argument("--suite", default="micro",
                    help="microsim suite: micro (51 routes) or b2d220 "
                         "(Bench2Drive protocol, 44 types x 5 variants)")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    if not args.labels_only:
        from simlingo_tpu_torch.orchestration.babysitter import (Babysitter,
                                                                 LocalBackend,
                                                                 SlurmBackend)
        if args.microsim:
            jobs, backend = microsim_jobs(args.save_root, args.suite), LocalBackend()
        else:
            if not args.routes_dir:
                raise SystemExit("--routes-dir required unless --labels-only or --microsim")
            jobs = carla_jobs(args.routes_dir, args.save_root, args.leaderboard,
                              args.base_port, args.max_jobs)
            backend = SlurmBackend() if args.slurm else LocalBackend()
        sitter = Babysitter(jobs, backend, max_jobs_file="max_num_jobs.txt",
                            max_concurrent=args.max_jobs)
        counts = sitter.run(progress=lambda c: print(c, flush=True))
        print("microsim collection jobs:" if args.microsim else "collection jobs:", counts)
    return run_label_generation(args.save_root)


if __name__ == "__main__":
    main()

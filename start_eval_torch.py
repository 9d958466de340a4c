#!/usr/bin/env python
"""Closed-loop evaluation orchestration for the PyTorch port.

The port's counterpart of `start_eval.py`, with the same flags plus
`--device`: one babysat job per route, fanned out with crash detection and
resubmission; afterwards the per-route result JSONs merge into mean driving
score + success rate (Bench2Drive protocol), with the ability and
efficiency breakdown, into `<output-dir>/merged.json`.

    # the in-repo microsim (no CARLA), one MicroBench route per job
    python start_eval_torch.py --microsim --checkpoint <ckpt> --max-jobs 1

    # a tiny random model on the CPU (pipeline smoke)
    python start_eval_torch.py --microsim --agent-kind tiny-model --device cpu

    # CARLA: one leaderboard evaluator per route with the port's plugin
    python start_eval_torch.py --checkpoint <ckpt> --routes-dir <xml dir> \\
        --carla-root $CARLA_ROOT --max-jobs 4

    # the privileged expert in the microsim (host numpy, no model)
    python start_eval_torch.py --microsim --agent-kind expert

Each microsim job runs `python -m simlingo_tpu_torch.sim.suite` on
`--device` (default cuda; the expert's jobs ignore it).
"""

import argparse
import glob
import json
import os
from typing import List


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--routes-dir", default=None,
                    help="directory of per-route .xml files (bench2drive_split)")
    ap.add_argument("--leaderboard", default="leaderboard/leaderboard/leaderboard_evaluator.py")
    ap.add_argument("--carla-root", default=os.environ.get("CARLA_ROOT", ""))
    ap.add_argument("--output-dir", default="eval_results")
    ap.add_argument("--max-jobs", type=int, default=2)
    ap.add_argument("--base-port", type=int, default=2000)
    ap.add_argument("--slurm", action="store_true")
    ap.add_argument("--max-retries", type=int, default=3)
    ap.add_argument("--microsim", action="store_true",
                    help="evaluate in the in-repo microsim (no CARLA): one "
                         "babysat MicroBench route per job")
    ap.add_argument("--agent-kind", default="model",
                    choices=("model", "tiny-model", "expert"),
                    help="microsim agent (tiny-model/expert for smokes)")
    ap.add_argument("--suite", default="micro",
                    help="microsim suite: micro (51 routes) or b2d220 "
                         "(Bench2Drive protocol, 44 types x 5 variants)")
    ap.add_argument("--device", default="cuda",
                    help="the agent's device in every microsim job: cuda "
                         "(default) or cpu")
    return ap.parse_args(argv)


def build_jobs(args) -> List:
    """The babysitter's jobs: one microsim suite run or one leaderboard
    evaluator per route, each with its log and its result file."""
    from simlingo_tpu_torch.orchestration.babysitter import Job

    jobs = []
    if args.microsim:
        from simlingo_tpu_torch.sim.suite import SUITES
        for spec in SUITES[args.suite]():
            name = spec["route_id"]
            result = os.path.join(args.output_dir, f"{name}.json")
            cmd = ["python", "-m", "simlingo_tpu_torch.sim.suite",
                   "--suite", args.suite,
                   "--agent", args.agent_kind, "--routes", name,
                   "--out", result]
            if args.agent_kind == "model":
                cmd += ["--checkpoint", args.checkpoint]
            cmd += ["--device", args.device]
            jobs.append(Job(name=name, cmd=cmd,
                            log_path=os.path.join(args.output_dir, f"{name}.log"),
                            done_file=result, max_retries=args.max_retries))
    else:
        assert args.routes_dir and args.checkpoint, \
            "--routes-dir and --checkpoint required without --microsim"
        routes = sorted(glob.glob(os.path.join(args.routes_dir, "*.xml")))
        for i, route in enumerate(routes):
            name = os.path.splitext(os.path.basename(route))[0]
            result = os.path.join(args.output_dir, f"{name}.json")
            port = args.base_port + 10 * (i % max(args.max_jobs, 1))
            cmd = [
                "python", args.leaderboard,
                f"--routes={route}",
                "--agent=simlingo_tpu_torch/agent/carla_agent.py",
                f"--agent-config={args.checkpoint}",
                f"--checkpoint={result}",
                f"--port={port}",
                f"--traffic-manager-port={port + 6000}",
            ]
            jobs.append(Job(name=name, cmd=cmd,
                            log_path=os.path.join(args.output_dir, f"{name}.log"),
                            done_file=result, max_retries=args.max_retries))
    return jobs


def summarize(output_dir: str) -> dict:
    """Merge the route results under output_dir (driving score, success
    rate, per-km infractions; the ability / efficiency breakdown where the
    records carry scenario types) and write merged.json."""
    from simlingo_tpu_torch.eval.driving_score import merge_route_dir

    summary = merge_route_dir(output_dir)
    # ability / efficiency breakdown when records carry scenario types
    # (microsim records always do; CARLA records via --route-scenarios
    # on eval/b2d_benchmarks directly). Reads the same file set
    # merge_route_dir covers (*.json AND *.json.gz).
    try:
        import gzip

        from simlingo_tpu_torch.eval.b2d_benchmarks import (ability_benchmark,
                                                            driving_efficiency)
        records = []
        paths = sorted(glob.glob(os.path.join(output_dir, "*.json"))
                       + glob.glob(os.path.join(output_dir, "*.json.gz")))
        for path in paths:
            if os.path.basename(path) == "merged.json":
                continue
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                data = json.load(f)
            records.extend(data.get("_checkpoint", {}).get("records", [data]))
        ab = ability_benchmark(records)
        if any(v is not None for v in ab["ability"].values()):
            summary["ability"] = ab["ability"]
            summary["ability_mean"] = ab["ability_mean"]
        eff = driving_efficiency(records)
        if eff is not None:
            summary["driving_efficiency"] = eff
    except Exception as exc:  # analysis must never fail the eval run
        print(f"ability breakdown skipped: {exc}")
    print(json.dumps(summary, indent=2))
    with open(os.path.join(output_dir, "merged.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None) -> dict:
    from simlingo_tpu_torch.orchestration.babysitter import (Babysitter,
                                                             LocalBackend,
                                                             SlurmBackend)

    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    jobs = build_jobs(args)
    backend = SlurmBackend() if args.slurm else LocalBackend()
    sitter = Babysitter(jobs, backend, max_jobs_file="max_num_jobs.txt",
                        max_concurrent=args.max_jobs)
    counts = sitter.run(progress=lambda c: print(c, flush=True))
    print("jobs:", counts)
    return summarize(args.output_dir)


if __name__ == "__main__":
    main()

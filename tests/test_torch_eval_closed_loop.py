"""The port's closed-loop scorers and orchestration against JAX's (CPU).

`eval/driving_score.py` and `eval/b2d_benchmarks.py` are copies: fed the
same route records -- JAX's expert runs (a clean Accident route, a
traffic route with a min-speed event) and JAX's scripted drives (a
collision, a blocked ego), with their replay records -- both packages give
equal merges, parses, CSV files, ability tables, efficiency and
smoothness, and equal CLI output. The babysitter is held to JAX's tests
(retries, resume past done files, crash signatures). `start_eval_torch.py`
builds JAX's `start_eval.py` job list with the package swapped (the
suite module, the CARLA plugin's path) and `--device` added to each
microsim job, the expert's too; and one microsim job runs end to end
on the CPU through the babysitter (`--agent tiny-model --device cpu
--max-steps 3`), merged by `summarize` into merged.json.
"""

import gzip
import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from simlingo_tpu.eval import b2d_benchmarks as JB
from simlingo_tpu.eval import driving_score as JDS
from simlingo_tpu.orchestration import babysitter as JBS
from simlingo_tpu.sim.runner import expert_factory, run_route
from simlingo_tpu_torch.eval import b2d_benchmarks as TB
from simlingo_tpu_torch.eval import driving_score as TDS
from simlingo_tpu_torch.orchestration import babysitter as TBS
from simlingo_tpu_torch.orchestration.babysitter import (Babysitter, Job, LocalBackend,
                                                         log_has_crash)

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Scripted:
    def __init__(self, control):
        self.control = control

    def step(self):
        return self.control

    def destroy(self, record=None):
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Route records of JAX's microsim, one file each (two gzipped), and
    the replay records under recs/<route_id>/records.json.gz."""
    root = tmp_path_factory.mktemp("runs")
    recs = str(root / "recs")
    drives = [
        ({"town": "straight", "start_s": 5.0, "end_s": 120.0, "route_id": "accident",
          "scenarios": [{"type": "Accident", "at_s": 70.0}]}, expert_factory(), None),
        ({"town": "straight", "start_s": 5.0, "end_s": 120.0, "route_id": "traffic",
          "npcs": [{"at_s": 45.0, "lane": 0, "speed": 6.0},
                   {"at_s": 60.0, "lane": 2, "speed": 7.0}]}, expert_factory(), None),
        ({"town": "straight", "start_s": 5.0, "end_s": 150.0, "route_id": "crash",
          "scenarios": [{"type": "ParkedObstacle", "at_s": 60.0}]},
         lambda w, r, s: _Scripted((0.0, 0.75, 0.0)), 700),
        ({"town": "straight", "start_s": 5.0, "end_s": 100.0, "route_id": "stuck",
          "scenarios": [{"type": "DynamicObjectCrossing", "at_s": 60.0}]},
         lambda w, r, s: _Scripted((0.0, 0.0, 1.0)), None),
    ]
    records, files = [], []
    for i, (spec, factory, steps) in enumerate(drives):
        rec = run_route(spec, factory, max_steps=steps, record_dir=recs, index=i)
        records.append(rec)
        path = str(root / (f"{spec['route_id']}.json" + ("" if i % 2 == 0 else ".gz")))
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "wt") as f:
            json.dump({"_checkpoint": {"records": [rec]}}, f)
        files.append(path)
    merged = str(root / "all" / "merged_results.json")
    os.makedirs(os.path.dirname(merged))
    with open(merged, "w") as f:
        json.dump({"_checkpoint": {"records": records}}, f)
    return records, files, recs, merged


def test_the_records_cover_the_infractions(runs):
    records = runs[0]
    assert [r["status"] for r in records[:2]] == ["Perfect", "Completed"]
    assert records[1]["infractions"]["min_speed_infractions"]
    assert records[2]["infractions"]["collisions_vehicle"]
    assert records[3]["status"] == "Failed - Agent got blocked"


def test_driving_score_matches_jax(runs, tmp_path):
    records, files, _, _ = runs
    assert TDS.merge_route_results(files) == JDS.merge_route_results(files)
    assert TDS.merge_route_dir(os.path.dirname(files[0])) == \
        JDS.merge_route_dir(os.path.dirname(files[0]))
    assert TDS.parse_results(files) == JDS.parse_results(files)
    for r in records:
        assert TDS.parse_route_record(r) == JDS.parse_route_record(r)
        assert TDS.is_success(r) == JDS.is_success(r)
        assert TDS.driving_score(r["scores"]["score_route"], r["infractions"]) == \
            JDS.driving_score(r["scores"]["score_route"], r["infractions"])
        for name, events in r["infractions"].items():
            assert TDS._event_penalty(name, events) == JDS._event_penalty(name, events)
    csvs = [mod.results_to_csv(files, str(tmp_path / f"{tag}.csv"))
            for tag, mod in (("jax", JDS), ("torch", TDS))]
    assert Path(csvs[1]).read_text() == Path(csvs[0]).read_text()
    parsed = JDS.parse_results(files)
    out = [mod.write_result_csv(parsed, str(tmp_path / f"{tag}_parsed.csv"))
           for tag, mod in (("jax", JDS), ("torch", TDS))]
    assert Path(out[1]).read_text() == Path(out[0]).read_text()
    assert TDS.main(files) == JDS.main(files)


def test_b2d_benchmarks_match_jax(runs):
    records, _, recs, merged = runs
    assert TB.ABILITIES == JB.ABILITIES
    assert TB.ability_benchmark(records) == JB.ability_benchmark(records)
    assert TB.driving_efficiency(records) == JB.driving_efficiency(records)
    for r in records:
        assert TB.route_success(r) == JB.route_success(r)
        path = os.path.join(recs, r["route_id"], "records.json.gz")
        mt, mj = TB.metric_info_from_record(path), JB.metric_info_from_record(path)
        assert json.dumps(mt, sort_keys=True) == json.dumps(mj, sort_keys=True)
        assert TB.smoothness(mt, dt=0.05) == JB.smoothness(mj, dt=0.05)
    n, dt = 300, 0.05
    t = np.arange(n) * dt
    pos = np.stack([8.0 * t, 0.3 * np.sin(t)], 1)
    speeds = np.where((np.arange(n) // 10) % 2 == 0, 0.0, 10.0)
    for yaw, v in ((np.zeros(n), np.full(n, 8.0)), (np.cumsum(np.full(n, 1.5 * dt)), speeds)):
        mi = TB.metric_info_from_states(pos, yaw, v, dt)
        assert json.dumps(mi, sort_keys=True) == \
            json.dumps(JB.metric_info_from_states(pos, yaw, v, dt), sort_keys=True)
        assert TB.smoothness(mi, dt=dt) == JB.smoothness(mi, dt=dt)


def test_b2d_cli_matches_jax(runs, capsys):
    """tests/test_b2d_benchmarks.py's CLI over the merged records and the
    replay records, in both packages."""
    _, _, recs, merged = runs
    argv = ["--results", merged, "--metric-dir", recs]
    out = TB.main(argv)
    assert json.dumps(out, sort_keys=True, default=str) == \
        json.dumps(JB.main(argv), sort_keys=True, default=str)
    assert out["ability"]["Overtaking"] == 50.0       # Accident clean, ParkedObstacle hit
    assert 0.0 <= out["driving_smoothness"] <= 1.0


# ---------------------------------------------------------------------------
# the babysitter (tests/test_orchestration.py, through the port)
# ---------------------------------------------------------------------------

def test_babysitter_retries_and_completes(tmp_path):
    marker = tmp_path / "attempts"
    script = tmp_path / "flaky.py"
    script.write_text(
        "import os, sys\n"
        f"p = {str(marker)!r}\n"
        "n = int(open(p).read()) if os.path.exists(p) else 0\n"
        "open(p, 'w').write(str(n + 1))\n"
        "sys.exit(0 if n >= 1 else 1)\n")
    jobs = [Job(name="ok", cmd=[sys.executable, "-c", "print('done')"],
                log_path=str(tmp_path / "ok.log")),
            Job(name="flaky", cmd=[sys.executable, str(script)],
                log_path=str(tmp_path / "flaky.log"), max_retries=3)]
    counts = Babysitter(jobs, LocalBackend(), max_concurrent=2, poll_interval_s=0.05,
                        hang_timeout_s=300).run()
    assert counts["finished"] == 2 and counts["failed"] == 0
    assert marker.read_text() == "2"          # one retry
    assert [j.retries for j in jobs] == [0, 1]


def test_babysitter_gives_up_after_max_retries(tmp_path):
    job = Job(name="bad", cmd=[sys.executable, "-c", "import sys; sys.exit(3)"],
              log_path=str(tmp_path / "bad.log"), max_retries=2)
    counts = Babysitter([job], LocalBackend(), poll_interval_s=0.05).run()
    assert counts["failed"] == 1 and job.failed and job.retries == 2


def test_babysitter_resumes_past_done_files(tmp_path):
    done = tmp_path / "a.json"
    done.write_text("{}")
    touched = tmp_path / "relaunched"
    jobs = [Job(name="done-already",
                cmd=[sys.executable, "-c", f"open({str(touched)!r}, 'w').write('x')"],
                log_path=str(tmp_path / "a.log"), done_file=str(done)),
            Job(name="fresh",
                cmd=[sys.executable, "-c",
                     f"open({str(tmp_path / 'b.json')!r}, 'w').write('{{}}')"],
                log_path=str(tmp_path / "b.log"), done_file=str(tmp_path / "b.json"))]
    counts = Babysitter(jobs, LocalBackend(), max_concurrent=2, poll_interval_s=0.05,
                        hang_timeout_s=300).run()
    assert counts["finished"] == 2 and counts["failed"] == 0
    assert not touched.exists()


def test_crash_signatures(tmp_path):
    assert TBS.CRASH_SIGNATURES == JBS.CRASH_SIGNATURES
    log = tmp_path / "x.log"
    for sig in TBS.CRASH_SIGNATURES:
        log.write_text(f"starting...\n{sig}\n")
        assert log_has_crash(str(log)) and JBS.log_has_crash(str(log))
    log.write_text("all fine\n")
    assert not log_has_crash(str(log))
    assert not log_has_crash(str(tmp_path / "missing.log"))


# ---------------------------------------------------------------------------
# start_eval_torch.py
# ---------------------------------------------------------------------------

def _jax_jobs(monkeypatch, tmp_path, argv):
    """The jobs JAX's start_eval.py hands its babysitter for argv."""
    seen = []

    class Capture:
        def __init__(self, jobs, *a, **kw):
            seen.extend(jobs)

        def run(self, progress=None):
            return {"running": 0, "finished": len(seen), "failed": 0, "pending": 0}
    monkeypatch.setattr(JBS, "Babysitter", Capture)
    monkeypatch.setattr(sys, "argv", ["start_eval.py", *argv])
    _load("start_eval").main()
    return seen


@pytest.mark.parametrize("argv", [
    ["--microsim", "--checkpoint", "ckpt/model.pt"],
    ["--microsim", "--agent-kind", "tiny-model", "--suite", "b2d220", "--max-retries", "1"],
    ["--microsim", "--agent-kind", "expert"],
    ["--checkpoint", "ckpt/model.pt", "--routes-dir", "ROUTES", "--max-jobs", "3",
     "--base-port", "3000"]], ids=["microsim_model", "microsim_b2d220_tiny", "microsim_expert",
                                   "carla"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_start_eval_torch_builds_jaxs_jobs(monkeypatch, tmp_path, argv, device):
    routes = tmp_path / "routes"
    routes.mkdir()
    for name in ("r_b", "r_a", "r_c"):
        (routes / f"{name}.xml").write_text("<routes/>")
    argv = [str(routes) if a == "ROUTES" else a for a in argv]
    argv += ["--output-dir", str(tmp_path / "out")]
    want = _jax_jobs(monkeypatch, tmp_path, argv)
    SE = _load("start_eval_torch")
    got = SE.build_jobs(SE.parse_args(argv + ["--device", device]))
    assert len(got) == len(want) >= 3
    microsim = "--microsim" in argv
    for g, w in zip(got, want):
        cmd = [c.replace("simlingo_tpu.", "simlingo_tpu_torch.")
               .replace("simlingo_tpu/agent/", "simlingo_tpu_torch/agent/") for c in w.cmd]
        if microsim:
            cmd += ["--device", device]
        assert g.cmd == cmd
        assert (g.name, g.log_path, g.done_file, g.max_retries) == \
            (w.name, w.log_path, w.done_file, w.max_retries)
    if not microsim:
        assert got[0].cmd[3] == "--agent=simlingo_tpu_torch/agent/carla_agent.py"
        assert os.path.exists(ROOT / "simlingo_tpu_torch" / "agent" / "carla_agent.py")


def test_start_eval_torch_refuses_the_expert(tmp_path):
    """The expert is ported now and no longer refused: start_eval_torch
    builds its microsim jobs (one a route, `--agent expert`, no checkpoint)
    and the suite runs it, as JAX's do."""
    SE = _load("start_eval_torch")
    args = SE.parse_args(["--microsim", "--agent-kind", "expert",
                          "--output-dir", str(tmp_path)])
    jobs = SE.build_jobs(args)
    assert len(jobs) == 51
    assert all(j.cmd[j.cmd.index("--agent") + 1] == "expert" and "--checkpoint" not in j.cmd
               for j in jobs)
    from simlingo_tpu_torch.sim import suite
    summary = suite.main(["--agent", "expert", "--routes", "micro_00_free", "--max-steps",
                          "5", "--out", str(tmp_path / "expert.json")])
    assert summary["num_routes"] == 1


def test_one_microsim_job_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """start_eval_torch's job for micro_00_free with the tiny model on the
    CPU (3 steps), babysat, then merged by `summarize` (merge_route_dir,
    the ability breakdown, merged.json)."""
    monkeypatch.chdir(ROOT)
    SE = _load("start_eval_torch")
    out = tmp_path / "eval"
    args = SE.parse_args(["--microsim", "--agent-kind", "tiny-model", "--device", "cpu",
                          "--output-dir", str(out)])
    out.mkdir()
    job = next(j for j in SE.build_jobs(args) if j.name == "micro_00_free")
    job.cmd = job.cmd + ["--max-steps", "3"]
    counts = Babysitter([job], LocalBackend(), poll_interval_s=0.2,
                        hang_timeout_s=300).run()
    log = Path(job.log_path).read_text()
    assert counts == {"running": 0, "finished": 1, "failed": 0, "pending": 0}, log
    assert job.retries == 0
    with open(job.done_file) as f:
        rec = json.load(f)["_checkpoint"]["records"][0]
    assert rec["route_id"] == "micro_00_free" and rec["meta"]["duration_game"] == 0.15
    want = JDS.merge_route_dir(str(out))
    summary = SE.summarize(str(out))
    assert summary == json.loads((out / "merged.json").read_text())
    assert summary["num_routes"] == 1
    assert {k: summary[k] for k in want} == want
    assert set(summary) - set(want) <= {"ability", "ability_mean", "driving_efficiency"}
    shutil.rmtree(out)

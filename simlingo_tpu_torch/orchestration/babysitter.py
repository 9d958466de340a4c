"""Job babysitter: fan-out, crash detection, and resubmission.

Copy of `simlingo_tpu/orchestration/babysitter.py`.

Behavioral counterpart of reference `start_eval_simlingo.py` +
`collect_dataset_slurm.py` (SURVEY.md section 5.3): one route = one job =
one simulator process; scan logs for crash signatures, cancel hung jobs,
resubmit up to a retry limit; live-tunable concurrency via a max-jobs file.

Backends: local subprocesses (default) and SLURM (sbatch/squeue/scancel) --
selected per the environment, same Job/Babysitter interface.
"""

from __future__ import annotations

import dataclasses
import os
import shlex
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

CRASH_SIGNATURES = (
    "Watchdog exception - Timeout",          # reference collect_dataset:186+
    "Engine crash handling finished",
    "RuntimeError: Spawn failed",
    "connection closed",
    "Segmentation fault",
    "CUDA out of memory",
)


@dataclasses.dataclass
class Job:
    name: str
    cmd: List[str]
    log_path: str
    done_file: Optional[str] = None        # exists => job finished successfully
    retries: int = 0
    max_retries: int = 3
    proc: Optional[subprocess.Popen] = None
    slurm_id: Optional[str] = None
    started_at: float = 0.0
    finished: bool = False
    failed: bool = False


class LocalBackend:
    def submit(self, job: Job) -> None:
        os.makedirs(os.path.dirname(job.log_path) or ".", exist_ok=True)
        log = open(job.log_path, "a")
        job.proc = subprocess.Popen(job.cmd, stdout=log, stderr=log)
        job.started_at = time.time()

    def is_running(self, job: Job) -> bool:
        return job.proc is not None and job.proc.poll() is None

    def cancel(self, job: Job) -> None:
        if job.proc is not None and job.proc.poll() is None:
            job.proc.kill()


class SlurmBackend:
    def __init__(self, partition_file: str = "partition.txt"):
        self.partition_file = partition_file

    def _partition(self) -> str:
        if os.path.isfile(self.partition_file):
            return open(self.partition_file).read().strip()
        return "gpu"

    def submit(self, job: Job) -> None:
        cmd = ["sbatch", "--parsable", f"--partition={self._partition()}",
               f"--job-name={job.name}", f"--output={job.log_path}",
               "--wrap", " ".join(shlex.quote(c) for c in job.cmd)]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        job.slurm_id = out.stdout.strip()
        job.started_at = time.time()

    def is_running(self, job: Job) -> bool:
        if job.slurm_id is None:
            return False
        out = subprocess.run(["squeue", "-j", job.slurm_id, "-h"],
                             capture_output=True, text=True)
        return bool(out.stdout.strip())

    def cancel(self, job: Job) -> None:
        if job.slurm_id:
            subprocess.run(["scancel", job.slurm_id], check=False)


def log_has_crash(log_path: str, signatures=CRASH_SIGNATURES) -> bool:
    if not os.path.isfile(log_path):
        return False
    try:
        with open(log_path, errors="replace") as f:
            tail = f.read()[-200_000:]
    except OSError:
        return False
    return any(sig in tail for sig in signatures)


class Babysitter:
    """Run jobs with bounded concurrency, crash-scan logs, resubmit."""

    def __init__(self, jobs: Sequence[Job], backend=None,
                 max_jobs_file: Optional[str] = None,
                 max_concurrent: int = 4,
                 hang_timeout_s: float = 3600.0,
                 poll_interval_s: float = 5.0):
        self.jobs = list(jobs)
        self.backend = backend or LocalBackend()
        self.max_jobs_file = max_jobs_file
        self.max_concurrent = max_concurrent
        self.hang_timeout_s = hang_timeout_s
        self.poll_interval_s = poll_interval_s

    def _max_concurrent(self) -> int:
        if self.max_jobs_file and os.path.isfile(self.max_jobs_file):
            try:
                return int(open(self.max_jobs_file).read().strip())
            except ValueError:
                pass
        return self.max_concurrent

    def _job_succeeded(self, job: Job) -> bool:
        if job.done_file is not None:
            return os.path.exists(job.done_file)
        return job.proc is not None and job.proc.poll() == 0

    def step(self) -> Dict[str, int]:
        """One poll iteration. Returns counts."""
        running = [j for j in self.jobs
                   if not j.finished and self.backend.is_running(j)]
        # crash-scan + hang detection
        for j in running[:]:
            crashed = log_has_crash(j.log_path)
            hung = time.time() - j.started_at > self.hang_timeout_s
            if crashed or hung:
                self.backend.cancel(j)
                running.remove(j)
        # reap finished
        for j in self.jobs:
            if j.finished or self.backend.is_running(j):
                continue
            if j.started_at == 0.0:
                continue                       # never started
            if self._job_succeeded(j):
                j.finished = True
            elif j.retries < j.max_retries:
                j.retries += 1
                self.backend.submit(j)
            else:
                j.finished = True
                j.failed = True
        # launch new -- resume semantics: a job whose done_file already
        # exists (e.g. from an interrupted earlier run) is complete and is
        # never resubmitted, matching the reference babysitters' restart
        # behavior (start_eval_simlingo.py result-checkpoint skip).
        pending = []
        for j in self.jobs:
            if j.finished or j.started_at != 0.0:
                continue
            if j.done_file is not None and os.path.exists(j.done_file):
                j.finished = True
                continue
            pending.append(j)
        slots = self._max_concurrent() - sum(
            1 for j in self.jobs
            if not j.finished and self.backend.is_running(j))
        for j in pending[:max(slots, 0)]:
            self.backend.submit(j)
        return {
            "running": sum(1 for j in self.jobs
                           if not j.finished and self.backend.is_running(j)),
            "finished": sum(j.finished and not j.failed for j in self.jobs),
            "failed": sum(j.failed for j in self.jobs),
            "pending": sum(1 for j in self.jobs
                           if not j.finished and j.started_at == 0.0),
        }

    def run(self, progress: Optional[Callable[[Dict[str, int]], None]] = None
            ) -> Dict[str, int]:
        while True:
            counts = self.step()
            if progress:
                progress(counts)
            if counts["running"] == 0 and counts["pending"] == 0:
                return counts
            time.sleep(self.poll_interval_s)

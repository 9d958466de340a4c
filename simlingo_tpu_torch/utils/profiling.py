"""Profiling and timing helpers.

Counterpart of `simlingo_tpu/utils/profiling.py`, in PyTorch's idiom: a
timer that reads a value back after `torch.cuda.synchronize()` each
iteration, a `torch.profiler` capture that writes a Chrome trace, and a
latency histogram. `timed` and `LatencyHistogram.summary` return the JAX
helpers' keys, computed the same way.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List

import numpy as np


def _first_tensor(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync_value(x) -> float:
    """Waits for the device, then reads one element of the first tensor of
    `x` (a tensor, or a dict / list / tuple holding one) back to the host;
    a number or a numpy array gives its first element."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t = _first_tensor(x)
    if t is None:
        return float(np.asarray(x).reshape(-1)[0])
    return float(t.reshape(-1)[0])


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2,
          **kwargs) -> Dict[str, float]:
    """Run fn(*args) iters times; synchronize via readback each iteration."""
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    sync_value(out)
    lats: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync_value(out)
        lats.append(time.perf_counter() - t0)
    a = np.asarray(lats)
    return {"p50_ms": float(np.percentile(a, 50) * 1e3),
            "p90_ms": float(np.percentile(a, 90) * 1e3),
            "mean_ms": float(a.mean() * 1e3),
            "min_ms": float(a.min() * 1e3)}


@contextlib.contextmanager
def trace(log_dir: str = "profiles", name: str = "trace"):
    """`torch.profiler` over the block (CPU, and CUDA where there is a
    card); writes `<log_dir>/<name>.json`, a Chrome trace (chrome://tracing
    or Perfetto). Yields the profiler, whose `key_averages()` the caller
    may read after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


class LatencyHistogram:
    """Per-frame latency accumulator for the closed-loop agent."""

    def __init__(self):
        self.samples: List[float] = []

    def add(self, seconds: float) -> None:
        self.samples.append(seconds)

    def summary(self, drop_first: int = 1) -> Dict[str, float]:
        a = np.asarray(self.samples[drop_first:] or self.samples)
        return {"p50_ms": float(np.percentile(a, 50) * 1e3),
                "p90_ms": float(np.percentile(a, 90) * 1e3),
                "p99_ms": float(np.percentile(a, 99) * 1e3),
                "mean_ms": float(a.mean() * 1e3),
                "n": int(len(a))}

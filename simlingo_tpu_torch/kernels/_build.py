"""Build and load the hand-written CUDA kernels (ctypes route).

Every `csrc/*.cu` file is compiled by its own `nvcc` process -- all started
together -- into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

The libraries go to `build/simlingo_tpu_torch/<hash>/` at the repository
root, where <hash> covers the sources and the flags, so an edited kernel
is rebuilt and an unchanged one is loaded from the cache. Nothing is built
or imported when this module is imported: the first launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "simlingo_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or install the CUDA toolkit)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every csrc/*.cu (in parallel) unless cached; returns
    {kernel name: library path}."""
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {src.stem: out_dir / f"lib{src.stem}.so" for src in _sources()}
    todo = [src for src in _sources() if not paths[src.stem].exists()]
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC),
               "-Xptxas", "-v", "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        log = out.decode(errors="replace")
        (out_dir / f"{src.stem}.build.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"--- {src.name} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, paths[src.stem])
        if verbose:
            print(f"[build] {src.name}\n{log}", flush=True)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (builds all kernels first)."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            for stem, path in paths.items():
                _libs[stem] = ctypes.CDLL(str(path))
        return _libs[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def aligned16(t):
    """`t` contiguous with a 16-byte aligned start (kernels that read 16
    bytes a thread need it); copies only when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count

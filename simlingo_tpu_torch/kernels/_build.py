"""Build and load the hand-written CUDA kernels (ctypes route).

Every `csrc/*.cu` file is compiled by its own `nvcc` process -- all started
together -- into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

The libraries go to `build/simlingo_tpu_torch/<hash>/` at the repository
root, where <hash> covers the sources and the flags, so an edited kernel
is rebuilt and an unchanged one is loaded from the cache. Nothing is built
or imported when this module is imported: the first launch builds.

`build_host` compiles a host library (csrc/*.cc, plain C interface) with
g++ the same way, into `build/simlingo_tpu_torch/host-<hash>/`.
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


HOST_FLAGS = ["-O3", "-march=native", "-ffast-math", "-funroll-loops", "-fPIC",
              "-fopenmp", "-std=c++17", "-shared"]


def build_host(name: str, libs=()) -> Path:
    """Compile csrc/<name>.cc with g++ (cached by source and flags); returns
    the library's path. Raises RuntimeError with the compiler's output when
    the build fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found (set CXX)")
    # -march=native: the key holds the CPU g++ targets, so a build/ directory
    # copied to another machine is rebuilt there, not loaded
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    src = CSRC / f"{name}.cc"
    h = hashlib.sha256(" ".join(HOST_FLAGS + list(libs)).encode())
    h.update(target.encode())
    h.update(src.read_bytes())
    out_dir = BUILD_ROOT / f"host-{h.hexdigest()[:16]}"
    path = out_dir / f"lib{name}.so"
    if path.exists():
        return path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.so.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *HOST_FLAGS, str(src), "-o", str(tmp), *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {src.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


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

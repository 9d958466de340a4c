"""JPEG decode for the data pipeline: the port's native loader, else cv2.

Counterpart of `simlingo_tpu/data/imageio.py` (`load_rgb` :26,
`load_rgb_preprocessed` :44) and of the ctypes bindings in
`simlingo_tpu/native/__init__.py`, over the port's own copy of the loader,
`csrc/loader.cc`. The order is the JAX package's:

  1. the native loader (libjpeg, GIL-free through ctypes), built with g++
     at first use by `kernels/_build.build_host` into `build/`;
  2. cv2, where the native loader cannot be built or loaded (no libjpeg
     header, no g++) or SIMLINGO_NATIVE=0;
  3. a RuntimeError that names both.

`decoder()` says which one this process uses, and why the native loader
is not used where it is not.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_native_error: Optional[str] = None
_U8P = ctypes.POINTER(ctypes.c_ubyte)


def _load() -> Optional[ctypes.CDLL]:
    """The native loader, built and bound once; None (with the reason in
    `_native_error`) where it cannot be."""
    global _lib, _native_error
    with _lock:
        if _lib is not None or _native_error is not None:
            return _lib
        if os.environ.get("SIMLINGO_NATIVE", "1") == "0":
            _native_error = "SIMLINGO_NATIVE=0"
            return None
        from simlingo_tpu_torch.kernels import _build
        try:
            lib = ctypes.CDLL(str(_build.build_host("loader", ["-ljpeg"])))
        except (RuntimeError, OSError) as e:
            lines = str(e).strip().splitlines() or [repr(e)]
            _native_error = next((ln for ln in lines if "error" in ln), lines[0])[:300]
            return None
        lib.sl_version.restype = ctypes.c_int
        lib.sl_jpeg_dims.restype = ctypes.c_int
        lib.sl_jpeg_dims.argtypes = [_U8P, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]
        batch = [ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
        lib.sl_decode_jpeg_batch.restype = ctypes.c_int
        lib.sl_decode_jpeg_batch.argtypes = batch + [_U8P, ctypes.c_int, ctypes.c_int]
        lib.sl_preprocess_jpeg_batch.restype = ctypes.c_int
        lib.sl_preprocess_jpeg_batch.argtypes = batch + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_float)]
        if lib.sl_version() != 1:
            _native_error = f"loader version {lib.sl_version()} != 1"
            return None
        _lib = lib
        return _lib


def decoder() -> Tuple[str, Optional[str]]:
    """("native", None), or ("cv2", why the native loader is not used);
    raises where neither is available."""
    if _load() is not None:
        return "native", None
    _cv2()
    return "cv2", _native_error


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"no JPEG decoder: the native loader (csrc/loader.cc) is unavailable "
            f"({_native_error}) and cv2 does not import ({e})") from None
    return cv2


def _buffers(blobs: Sequence[bytes]):
    n = len(blobs)
    ptrs = (_U8P * n)()
    lens = (ctypes.c_size_t * n)()
    for i, b in enumerate(blobs):       # the caller keeps `blobs` alive
        ptrs[i] = ctypes.cast(ctypes.c_char_p(b), _U8P)
        lens[i] = len(b)
    return ptrs, lens


def jpeg_dims(blob: bytes) -> Tuple[int, int]:
    """(h, w) of a JPEG stream (native loader)."""
    lib = _load()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.sl_jpeg_dims(ctypes.cast(ctypes.c_char_p(blob), _U8P), len(blob),
                          ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"sl_jpeg_dims failed rc={rc}")
    return h.value, w.value


def decode_jpeg_batch(blobs: Sequence[bytes], h: int, w: int) -> np.ndarray:
    """n same-sized JPEG byte strings -> [n, h, w, 3] uint8 RGB (native)."""
    lib = _load()
    out = np.empty((len(blobs), h, w, 3), np.uint8)
    ptrs, lens = _buffers(blobs)
    rc = lib.sl_decode_jpeg_batch(ptrs, lens, len(blobs),
                                  out.ctypes.data_as(_U8P), h, w)
    if rc != 0:
        raise ValueError(f"sl_decode_jpeg_batch failed rc={rc}")
    return out


def load_rgb(path: str) -> np.ndarray:
    """JPEG file -> uint8 HWC RGB array."""
    if _load() is not None:
        try:
            with open(path, "rb") as f:
                blob = f.read()
            h, w = jpeg_dims(blob)
            return decode_jpeg_batch([blob], h, w)[0]
        except (ValueError, OSError):
            pass          # a corrupt or unsupported stream: cv2 gives its verdict
    cv2 = _cv2()
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"unreadable image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def load_rgb_preprocessed(path: str, image_size: int = 448,
                          max_num_grid: int = 2, do_bottom_crop: bool = True
                          ) -> Optional[np.ndarray]:
    """Decode -> crop -> resize -> normalize -> tiles in one native call
    ([NP, S, S, 3] float32, as image_pipe.preprocess_numpy); None where the
    native loader is unavailable or refuses the stream."""
    lib = _load()
    if lib is None:
        return None
    from simlingo_tpu_torch.data.image_pipe import device_grid_for
    try:
        with open(path, "rb") as f:
            blob = f.read()
        h, w = jpeg_dims(blob)
    except (ValueError, OSError):
        return None
    gw, gh = device_grid_for(w, h, image_size, max_num=max_num_grid,
                             do_bottom_crop=do_bottom_crop)
    out = np.empty((1, gh * gw, image_size, image_size, 3), np.float32)
    ptrs, lens = _buffers([blob])
    rc = lib.sl_preprocess_jpeg_batch(ptrs, lens, 1, h, w, image_size, gw, gh,
                                      int(do_bottom_crop),
                                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out[0] if rc == 0 else None

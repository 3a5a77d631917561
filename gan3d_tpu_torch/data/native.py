"""ctypes binding of the native npz decoder, native/npz_loader.cc.

The port's counterpart of gan3d_tpu/data/native.py: the same C++ source
(zip parse, zlib inflate and the clip to [-1, 1], on a thread pool), built
with ``g++`` at first use into ``gan3d_tpu_torch/_build/npz_loader-<hash of
the source and flags>/libnpz_loader.so``; the repo's
``native/libnpz_loader.so`` is never written. ``available()`` says whether
the build and load succeeded; ``NpzDirDataset(native=True)`` falls back to
numpy with a printed line when they did not. Host code: nothing here
touches the card, and nothing runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "npz_loader.cc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> str:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_ROOT, f"npz_loader-{h.hexdigest()[:16]}",
                        "libnpz_loader.so")


def _build(so: str) -> None:
    """g++ into a temporary file beside ``so``, then renamed over it (a
    concurrent build of the same source writes the same file)."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, SRC, "-o", tmp, "-lz"], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            so = library_path()
            if not os.path.isfile(so):
                _build(so)
            lib = ctypes.CDLL(so)
        except Exception as e:  # noqa: BLE001 — no g++, no zlib, no source
            print(f"native npz loader build failed: {e}", flush=True)
            _failed = True
            return None
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [ctypes.c_int]
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        lib.loader_decode_batch.restype = ctypes.c_int
        lib.loader_decode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeNpzPool:
    """Thread-pooled batch decoder: paths -> float32 [n, *shape] in
    [-1, 1]."""

    def __init__(self, num_threads: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError("native npz loader unavailable")
        self._lib = lib
        self._pool = lib.loader_create(num_threads)

    def decode_batch(self, paths: Sequence[str], sample_shape) -> np.ndarray:
        n = len(paths)
        per = int(np.prod(sample_shape))
        out = np.empty((n, per), np.float32)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        rc = self._lib.loader_decode_batch(
            self._pool, arr, n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), per)
        if rc != 0:
            raise IOError(f"native npz decode failed (code {rc})")
        return out.reshape((n,) + tuple(sample_shape))

    def __del__(self):
        lib, pool = getattr(self, "_lib", None), getattr(self, "_pool", None)
        if lib is not None and pool:
            lib.loader_destroy(pool)

"""Build and load the port's CUDA libraries.

Each source ``gan3d_tpu_torch/csrc/<name>.cu`` has a plain C interface and
is compiled by ``nvcc`` for ``sm_90a`` into a shared library at first use,
cached as ``gan3d_tpu_torch/_build/<hash>/lib<name>.so`` (the hash covers
the source, every shared header ``csrc/*.cuh`` and the flags)
beside the compiler's register and spill report (``ptxas.log``, from
``-Xptxas -v``). ``build`` starts one ``nvcc`` per missing library, all at
once, and waits for them; ``load`` opens a built library with ``ctypes``.

Nothing here runs at import time: this module imports on a machine with
no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMS = 132  # streaming multiprocessors of an H100 SXM: the plans fill them

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then PATH, then /usr/local/cuda; raises if none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built")


def headers() -> List[str]:
    """Every ``csrc/*.cuh``, sorted: a source may include any of them."""
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cuh"))


def library_path(name: str) -> str:
    """The cached library's path: a hash of the source, every shared
    header and the flags, so an edited header builds anew."""
    h = hashlib.sha256()
    for path in (source(name), *headers()):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], f"lib{name}.so")


def build(*names: str) -> List[str]:
    """Compile every named library whose cached copy is missing, one
    ``nvcc`` each, all started together; returns the libraries' paths.
    Raises with the compiler's output if any build fails."""
    paths = [library_path(n) for n in names]
    jobs = []
    try:
        for name, path in zip(names, paths):
            if os.path.isfile(path):
                continue
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
            os.close(fd)
            proc = subprocess.Popen(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, path, tmp, proc))
        errors = []
        for name, path, tmp, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {name}.cu ({proc.returncode}):"
                              f"\n{out}")
                continue
            with open(os.path.join(os.path.dirname(path), "ptxas.log"),
                      "w") as f:
                f.write(out)
            os.replace(tmp, path)
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The named library, built if needed and opened once per process."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build(name)[0])
        return _libs[name]

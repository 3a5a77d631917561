"""The pooled-attention CUDA kernels: build, bind and autograd wrapper.

The kernels live in ``gan3d_tpu_torch/csrc/pooled_attention.cu`` (forward
and the FlashAttention-2 split backward; its header says what they replace
and what bounds them). They are compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use, cached under
``gan3d_tpu_torch/_build/<hash of the source>/``, and called through
``ctypes`` on PyTorch's current stream.

Nothing here touches CUDA or ``nvcc`` at import time. Every wrapper takes
only CUDA tensors and raises on anything the kernels do not take; the
dispatcher in ``ops/attention.py`` sends CPU tensors to the plain version.

``fwd_launches`` / ``bwd_launches`` count the launches of each wrapper, so
a run can show that its attention went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

SUPPORTED_C = (8, 16, 32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "pooled_attention.cu")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

fwd_launches = 0
bwd_launches = 0

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_counters() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0


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
        "the pooled-attention kernels cannot be built")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, digest, "libpooled_attention.so")


def build() -> str:
    """Compile the kernels if the cached library is missing; returns its path.

    The compiler's register and spill report (``-Xptxas -v``) is kept next
    to the library as ``ptxas.log``.
    """
    path = library_path()
    if os.path.isfile(path):
        return path
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pa_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
            lib.pa_fwd.restype = i
            lib.pa_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                   i, i, i, i, i, p]
            lib.pa_bwd.restype = i
            _lib = lib
    return _lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ValueError unless the kernels take (q, k, v)."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"pooled-attention kernel: dtype {q.dtype} not in "
                         f"(float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("pooled-attention kernel: q, k, v dtypes differ: "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("pooled-attention kernel: want q [N,L,c], "
                         f"k/v [N,M,c]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n, L, c = q.shape
    if k.shape[0] != n or k.shape[2] != c:
        raise ValueError(f"pooled-attention kernel: q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} disagree on N or c")
    if c not in SUPPORTED_C:
        raise ValueError(f"pooled-attention kernel: c={c} not in {SUPPORTED_C}")
    if L == 0 or k.shape[1] == 0:
        raise ValueError("pooled-attention kernel: empty L or M")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"pooled-attention kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
    if not (q.device == k.device == v.device):
        raise ValueError("pooled-attention kernel: q, k, v on different "
                         "devices")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_if(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"pooled-attention {what} kernel launch failed: "
                           f"cudaError {err}")


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: returns (o [N,L,c] in q's dtype, lse [N,L] f32)."""
    global fwd_launches
    check_inputs(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    n, L, c = q.shape
    m = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((n, L), dtype=torch.float32, device=q.device)
    lib = _load()
    with torch.cuda.device(q.device):
        err = lib.pa_fwd(_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse),
                         n, L, m, c, _DTYPE_CODE[q.dtype], _stream(q))
    _raise_if(err, "forward")
    fwd_launches += 1
    return o, lse


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward kernels: (dq, dk, dv) in the dtypes of (q, k, v)."""
    global bwd_launches
    check_inputs(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:2]:
        raise ValueError("pooled-attention backward: o/dO/lse shapes "
                         f"{tuple(o.shape)}, {tuple(do.shape)}, "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or not (o.is_cuda and do.is_cuda
                                           and lse.is_cuda):
        raise ValueError("pooled-attention backward: lse must be f32 and "
                         "o, dO, lse on the CUDA device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = o.contiguous()
    do = do.to(q.dtype).contiguous()
    lse = lse.contiguous()
    n, L, c = q.shape
    m = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((n, L), dtype=torch.float32, device=q.device)
    lib = _load()
    with torch.cuda.device(q.device):
        err = lib.pa_bwd(_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do),
                         _ptr(lse), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(delta),
                         n, L, m, c, _DTYPE_CODE[q.dtype], _stream(q))
    _raise_if(err, "backward")
    bwd_launches += 1
    return dq, dk, dv


class PooledAttentionFunction(torch.autograd.Function):
    """softmax(q k^T) v through the kernels. First-order only, like the JAX
    package's custom_vjp: a double backward raises."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return attention_bwd(q, k, v, o, lse, do)


def pooled_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                          ) -> torch.Tensor:
    """softmax(q k^T) v through the kernels (they check the inputs)."""
    return PooledAttentionFunction.apply(q.contiguous(), k.contiguous(),
                                         v.contiguous())

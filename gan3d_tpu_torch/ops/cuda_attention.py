"""The pooled-attention CUDA kernels: build, bind and autograd wrapper.

The kernels live in ``gan3d_tpu_torch/csrc/pooled_attention.cu`` (forward
and the FlashAttention-2 split backward; its header says what they replace
and what bounds them). ``ops/cuda_build.py`` compiles them into a shared
library with a plain C interface at first use; they are called through
``ctypes`` on PyTorch's current stream.

Nothing here touches CUDA or ``nvcc`` at import time. Every wrapper takes
only CUDA tensors and raises on anything the kernels do not take; the
dispatcher in ``ops/attention.py`` sends CPU tensors to the plain version.

The forward and the backward each have two routes, picked by dtype, both
on the tensor cores: bf16 goes to the bf16 kernels (``pa_fwd_tc``,
``pa_bwd_tc``), f32 to the 3xTF32 kernels (``pa_fwd``, ``pa_bwd``: each
f32 operand split into two TF32 halves, three products a term, f32
accurate); each backward's dk/dv pass is split over L into ``dkdv_split``
parts. Any other dtype raises. Nothing falls back.

``fwd_launches`` / ``bwd_launches`` (f32 route) and ``fwd_tc_launches`` /
``bwd_tc_launches`` (bf16 route) count the wrappers' launches, so a run
can show that its attention went through the kernels and which ones.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from gan3d_tpu_torch.ops import cuda_build
from gan3d_tpu_torch.ops.cuda_build import SMS

SUPPORTED_C = (8, 16, 32, 64, 128)
WIDE_C = 64  # above it the dk/dv pass changes its blocks (dkdv_blocks)
F32_PART_QUERIES = 2048  # f32 route: queries a dk/dv part sums at most
_DTYPES = (torch.float32, torch.bfloat16)

fwd_launches = 0
fwd_tc_launches = 0
bwd_launches = 0
bwd_tc_launches = 0

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_counters() -> None:
    global fwd_launches, fwd_tc_launches, bwd_launches, bwd_tc_launches
    fwd_launches = 0
    fwd_tc_launches = 0
    bwd_launches = 0
    bwd_tc_launches = 0


def dkdv_blocks(c: int, f32: bool = False) -> Tuple[int, int, int]:
    """The dk/dv grid of a route at c: (key rows a block, queries a staged
    tile, column halves a key block). bf16: 64 rows over 64-query tiles,
    two halves above WIDE_C; f32: 64 over 64, but at c = 128 128 rows (8
    warps) over 32-query tiles, all columns in one block. The library
    reports its own (``pa_bwd_grid``), which ``_load`` holds against
    this."""
    if not f32:
        return 64, 64, 2 if c > WIDE_C else 1
    return (128, 32, 1) if c > WIDE_C else (64, 64, 1)


def dkdv_split(n: int, L: int, m: int, c: int = WIDE_C,
               f32: bool = False) -> int:
    """Parts P of the dk/dv pass: 1 where the route's key blocks
    (``dkdv_blocks``: N x ceil(M / rows) x halves) already cover the card
    twice; else L's tiles are split into P parts (f32 partials [P, N, M,
    c], summed in a fixed order) so that the grid covers it about twice.
    The f32 route (``f32``) also keeps each part to F32_PART_QUERIES
    queries: the tensor cores' f32 sums are not rounded to nearest, and
    over the 32768 queries of a sample dk and dv drift past the route's
    1e-4; the parts' sums are."""
    rows, tile, halves = dkdv_blocks(c, f32)
    tiles = -(-L // tile)
    blocks = n * -(-m // rows) * halves
    parts = 1 if blocks >= 2 * SMS else min(tiles, -(-2 * SMS // blocks))
    if f32:
        parts = max(parts, -(-tiles // (F32_PART_QUERIES // tile)))
    return parts


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cuda_build.load("pooled_attention")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pa_fwd.argtypes = [p] * 5 + [i] * 4 + [p]
            lib.pa_fwd.restype = i
            lib.pa_fwd_tc.argtypes = [p] * 5 + [i] * 4 + [p]
            lib.pa_fwd_tc.restype = i
            lib.pa_bwd.argtypes = [p] * 12 + [i] * 5 + [p]
            lib.pa_bwd.restype = i
            lib.pa_bwd_tc.argtypes = [p] * 12 + [i] * 5 + [p]
            lib.pa_bwd_tc.restype = i
            lib.pa_bwd_grid.argtypes = [i, i, ctypes.POINTER(i)]
            lib.pa_bwd_grid.restype = i
            for c in SUPPORTED_C:
                for f32 in (False, True):
                    grid = (i * 3)()
                    if (lib.pa_bwd_grid(c, int(f32), grid) != 0
                            or tuple(grid) != dkdv_blocks(c, f32)):
                        raise RuntimeError(
                            f"pooled-attention library's dk/dv grid at c={c}"
                            f" ({'f32' if f32 else 'bf16'}) is "
                            f"{tuple(grid)}, not dkdv_blocks' "
                            f"{dkdv_blocks(c, f32)}")
            _lib = lib
    return _lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ValueError unless the kernels take (q, k, v)."""
    if q.dtype not in _DTYPES:
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels stage
    rows by 16-byte cp.async): a copy if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    """Forward kernel: returns (o [N,L,c] in q's dtype, lse [N,L] f32);
    bf16 in bf16 products, f32 in 3xTF32 ones."""
    global fwd_launches, fwd_tc_launches
    check_inputs(q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    n, L, c = q.shape
    m = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((n, L), dtype=torch.float32, device=q.device)
    lib = _load()
    tc = q.dtype == torch.bfloat16
    with torch.cuda.device(q.device):
        err = (lib.pa_fwd_tc if tc else lib.pa_fwd)(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), n, L, m, c,
            _stream(q))
    if tc:
        _raise_if(err, "forward (bf16)")
        fwd_tc_launches += 1
    else:
        _raise_if(err, "forward (f32)")
        fwd_launches += 1
    return o, lse


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward kernels: (dq, dk, dv) in the dtypes of (q, k, v); bf16 in
    bf16 products, f32 in 3xTF32 ones."""
    global bwd_launches, bwd_tc_launches
    check_inputs(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:2]:
        raise ValueError("pooled-attention backward: o/dO/lse shapes "
                         f"{tuple(o.shape)}, {tuple(do.shape)}, "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or not (o.is_cuda and do.is_cuda
                                           and lse.is_cuda):
        raise ValueError("pooled-attention backward: lse must be f32 and "
                         "o, dO, lse on the CUDA device")
    q, k, v, o = _aligned(q), _aligned(k), _aligned(v), _aligned(o)
    do = _aligned(do.to(q.dtype))
    lse = lse.contiguous()
    n, L, c = q.shape
    m = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((n, L), dtype=torch.float32, device=q.device)
    tc = q.dtype == torch.bfloat16
    parts = dkdv_split(n, L, m, c, f32=not tc)
    dkp, dvp = ((torch.empty((parts, n, m, c), dtype=torch.float32,
                             device=q.device) for _ in range(2))
                if parts > 1 else (dk, dv))
    lib = _load()
    with torch.cuda.device(q.device):
        err = (lib.pa_bwd_tc if tc else lib.pa_bwd)(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
            _ptr(dq), _ptr(dk), _ptr(dv), _ptr(delta), _ptr(dkp), _ptr(dvp),
            n, L, m, c, parts, _stream(q))
    if tc:
        _raise_if(err, "backward (bf16)")
        bwd_tc_launches += 1
    else:
        _raise_if(err, "backward (f32)")
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

"""The Mosaic probe ladders as a Hopper probe ladder.

Counterpart of scripts/probe_mosaic.py (its rungs' ``pl.pallas_call`` at
t_copy :48, t_dma :66, t_dma2 :99, t_concat :121, t_dot :153, t_full :199,
t_dslot :220, t_when :246, t_pds :267, t_pds_off :289, t_cost :301;
``run`` :23-35) and scripts/probe_mosaic2.py (t_lane :38, t_resh :56,
t_fwd :83). Each JAX rung was a tiny Pallas kernel adding one TPU
construct; each rung here computes exactly what its Pallas kernel
computes, on the same inputs (``X`` of
probe_mosaic.py:38-39, ``XT`` / ``W2`` of probe_mosaic2.py:23-27, from the
same numpy seeds), through one of four hand-written kernels in
``gan3d_tpu_torch/csrc/probe_ladder.cu`` that plays the TPU construct's
part (the file's header says which):

- box_copy, on a launch plan from ``box_plan`` (the box's
  source-contiguous rows merged, the grid, the box as a tensor for the
  copy unit): copy, cost_estimate (``CostEstimate`` has no CUDA
  counterpart: the copy kernel), lane_value_slice and minor_slice_reshape
  by direct loads; manual_dma, dma_dyn_slot, dma_when_guard, dma_pds_src,
  dma_pds_src_offset and dma_double_buffer by bulk tensor copies completed
  on an mbarrier, into a 1- or 2-slot ring, each slot written out by one
  bulk copy;
- im2col27: lane_concat27;
- gram27: wide_dot_accum and dw_skeleton (staged through the
  double-buffered bulk-copy ring), bf16 tensor-core products, f32 sums;
- wide_fwd: wide_fwd_skeleton.

The output ``BlockSpec`` of t_concat, t_dot, t_full and t_resh maps every
grid step to block (0, 0). On the TPU's sequential grid concat and resh
therefore return the last sample's values and dot and full the sum over
both samples; the rungs here compute exactly that.

Each rung ``t_*(inp, plain=False)`` dispatches as the port does: CPU
tensors go to the kernel's plain PyTorch version, CUDA tensors to the
kernel, which raises on what it does not take; ``plain=True`` asks for the
plain version explicitly (the card's comparisons). ``launches`` counts
each kernel's launches. ``run(name, fn)`` reports ``name OK (val)`` or
``FAIL ...`` and goes on; ``main()`` (``python -m
gan3d_tpu_torch.probes.mosaic_ladder``) runs every rung on the card, holds
it against its plain version, and exits 1 if any rung fails. It raises
when there is no CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import sys
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gan3d_tpu_torch.ops import cuda_build
from gan3d_tpu_torch.utils.platform import resolve_device

# probe_mosaic.py's X [2, 8, 8, 8, 32] and its 27 shifted 6^3 views
N, S, C, V = 2, 8, 32, 6
# probe_mosaic2.py: channels-first padded samples XT [2, CI, DD, H+2, W+2]
CI, DD, H, W = 16, 2, 8, 8
TAPS = [(t // 9, (t // 3) % 3, t % 3) for t in range(27)]
KERNELS = ("box_copy", "im2col27", "gram27", "wide_fwd")
# Tolerance per kernel, as max |kernel - plain| / max |plain|: copies are
# bit-equal; the products sum bf16 products in f32 in another order (f32
# outputs), or round the f32 sum to bf16 (2^-8 relative).
TOL = {"box_copy": 0.0, "im2col27": 0.0, "gram27": 1e-5, "wide_fwd": 2e-2}
# im2col27_kernel's output rows a block (csrc/probe_ladder.cu kIm2colRows):
# 72 blocks of 108 threads.
IM2COL_ROWS = 3

launches = {k: 0 for k in KERNELS}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_counters() -> None:
    for k in KERNELS:
        launches[k] = 0


class Inputs(NamedTuple):
    x: torch.Tensor    # [2, 8, 8, 8, 32] bf16
    xt: torch.Tensor   # [2, 16, 2, 10, 10] bf16
    w2: torch.Tensor   # [8, 432] bf16


def inputs(device) -> Inputs:
    """The probes' inputs from their numpy seeds (f64 rounded to bf16)."""
    arrays = (np.random.default_rng(0).normal(size=(N, S, S, S, C)),
              np.random.default_rng(0).normal(size=(2, CI, DD, H + 2, W + 2)),
              np.random.default_rng(1).normal(size=(8, 27 * CI)))
    return Inputs(*(torch.from_numpy(a).to(device, torch.bfloat16)
                    for a in arrays))


class Box(NamedTuple):
    """Rows of ``length`` contiguous values at element offset
    off + i*sn + j*sa + k*sb, i < n, j < a, k < b; copied to [n, a, b,
    length]."""
    off: int
    n: int
    a: int
    b: int
    length: int
    sn: int
    sa: int
    sb: int


SAMPLE = S * S * S * C
XT_SAMPLE = CI * DD * (H + 2) * (W + 2)
WHOLE = Box(0, N, 1, 1, SAMPLE, SAMPLE, 0, 0)                # x[i]
PDS = Box(0, N, 6, 6, S * C, SAMPLE, S * S * C, S * C)      # x[i, :6, :6]
# x[i, 1:7, 1:7, 2:8]: rows of 6*32 values starting 128 bytes in
PDS_OFF = Box(S * S * C + S * C + 2 * C, N, 6, 6, 6 * C, SAMPLE, S * S * C,
              S * C)
# xt[i, :, :, :, 1:9]: (ci, dd) merge into one axis of stride 100
LANE = Box(1, 2, CI * DD, H + 2, W, XT_SAMPLE, (H + 2) * (W + 2), W + 2)
# xt[last, :, :, 1:9, 2:10]
RESH = Box(XT_SAMPLE + (W + 2) + 2, 1, CI * DD, H, W, XT_SAMPLE,
           (H + 2) * (W + 2), W + 2)


class Plan(NamedTuple):
    """box_copy_kernel's launch plan (csrc/probe_ladder.cu ``Plan``, field
    for field). Row (j, k) of sample s, after merging the box's
    source-contiguous rows, holds ``length`` values from element off +
    s*sn + j*sa + k*sb, j < rows / b, k < b; the output is [n, rows,
    length]. Direct (``bulk`` 0): blocks of ``threads``, 2**tx_log2 of them
    along a row and the rest over rows, each moving ``items`` 16-byte units
    of its row. Bulk: the box as a tensor of ``rank`` dims from element off
    (innermost first, the last the samples; extents ``dims``, element
    strides ``strides`` of dims 1.., padded to 5 dims), a block's share of
    a sample the sub-box ``box``, the sample split over ``parts`` blocks
    along its outermost dim (rank - 2), each block (one warp) walking
    ``walk`` samples through a ring of ``slots`` slots. grid_* is the
    launch grid. ``stop`` (bulk, for measurement) ends the kernel early: 1
    at entry, 2 after the barrier init, 3 with the copy landed but not
    written out."""
    n: int
    off: int
    sn: int
    sa: int
    sb: int
    b: int
    rows: int
    length: int
    bulk: int
    threads: int
    tx_log2: int
    items: int
    rank: int
    parts: int
    walk: int
    slots: int
    dims: Tuple[int, ...]
    strides: Tuple[int, ...]
    box: Tuple[int, ...]
    grid_x: int
    grid_y: int
    grid_z: int
    stop: int = 0


DIRECT_THREADS = 128   # a direct block
MAX_ITEMS = 2          # 16-byte units a direct thread moves (kMaxItems)
TENSOR_BOX = 256       # the most values of a tensor copy's box along a dim
# Where a block takes one sample (walk 1), the sample is split over as many
# blocks of at least BLOCK_BYTES as its outermost dim allows: the copies'
# landing and write-out on one SM are what a bulk rung waits for (PERF.md
# section 6), and more SMs share them.
BLOCK_BYTES = 2048
MAX_SMEM = 227 * 1024


def merged_rows(box: Box) -> Tuple[int, int, int, int, int]:
    """(a, b, length, sa, sb) of the box with source-contiguous rows merged:
    the b rows of a j-plane when sb == length, then the a planes when they
    are contiguous in turn."""
    a, b, length, sa, sb = box.a, box.b, box.length, box.sa, box.sb
    if b > 1 and sb == length:
        length, b, sb = length * b, 1, 0
    if b == 1 and a > 1 and sa == length:
        length, a, sa = length * a, 1, 0
    return a, b, length, sa, sb


def tensor_dims(box: Box) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(extents, element strides of dims 1..) of the box as a tensor for
    the copy unit, innermost first: a merged row cut into rows of at most
    TENSOR_BOX values, then the b rows, the a planes, the samples; dims of
    extent 1 dropped. Raises where a dim would pass TENSOR_BOX."""
    a, b, length, sa, sb = merged_rows(box)
    inner = min(length, TENSOR_BOX)
    if length % inner:
        raise ValueError(f"box_copy kernel: rows of {length} values do not "
                         f"cut into rows of {TENSOR_BOX}")
    dims = [(inner, 1)] + [(e, st) for e, st in ((length // inner, inner),
                                                 (b, sb), (a, sa)) if e > 1]
    if any(e > TENSOR_BOX for e, _ in dims):
        raise ValueError(f"box_copy kernel: {box} has a dim past "
                         f"{TENSOR_BOX} values")
    dims.append((box.n, box.sn))
    return tuple(e for e, _ in dims), tuple(st for _, st in dims[1:])


def _divisors(m: int):
    return [d for d in range(1, m + 1) if m % d == 0]


@functools.lru_cache(maxsize=None)
def box_plan(box: Box, walk: int = 1, slots: int = 1, bulk: bool = False,
             parts: Optional[int] = None) -> Plan:
    """The launch plan of the box: direct loads (``walk`` and ``slots`` 1),
    or one tensor copy a block and sample into a ring of ``slots``, a
    sample split over ``parts`` blocks along its outermost dim (by
    default 1 where a block walks several samples, else as many blocks of
    at least BLOCK_BYTES as divide that dim; other values for
    measurements). Raises on a box the kernel does not take: rows not
    whole 16-byte units, element offsets past 32 bits, tensor copies off
    16 bytes."""
    a, b, length, sa, sb = merged_rows(box)
    rows = a * b
    last = (box.off + (box.n - 1) * box.sn + (box.a - 1) * box.sa
            + (box.b - 1) * box.sb + box.length)
    if length % 8 or min(box.off, box.sn, box.sa, box.sb) < 0 \
            or max(last, box.n * box.sn, box.n * rows * length) >= 2 ** 31:
        raise ValueError(f"box_copy kernel: {box} is not rows of whole "
                         "16-byte units within 32-bit offsets")
    if not bulk:
        if walk != 1 or slots != 1 or parts not in (None, 1):
            raise ValueError("box_copy kernel: walk, slots and parts are "
                             "bulk-mode parameters")
        units = length // 8
        tx = min(1 << (units - 1).bit_length(), DIRECT_THREADS)
        items = min(MAX_ITEMS, -(-units // tx))
        return Plan(box.n, box.off, box.sn, sa, sb, b, rows, length, 0,
                    DIRECT_THREADS, tx.bit_length() - 1, items, 0, 1, 1, 1,
                    (1,) * 5, (0,) * 4, (1,) * 5,
                    -(-units // (tx * items)),
                    -(-rows // (DIRECT_THREADS // tx)), box.n)
    dims, strides = tensor_dims(box)
    rank, split = len(dims), len(dims) - 2
    if any(v % 8 for v in (box.off, dims[0]) + strides) or walk < 1 \
            or box.n % walk or slots not in (1, 2):
        raise ValueError(f"box_copy kernel: tensor copies of {box} (walk "
                         f"{walk}, slots {slots}) are not 16-byte aligned "
                         "or the samples do not split into walks")
    if parts is None:
        parts = 1 if walk > 1 else max(
            d for d in _divisors(dims[split])
            if d == 1 or (2 * rows * length // d >= BLOCK_BYTES
                          and (split or dims[0] // d % 8 == 0)))
    if dims[split] % parts or (split == 0 and dims[0] // parts % 8):
        raise ValueError(f"box_copy kernel: {parts} parts do not divide "
                         f"{box}")
    sub = tuple(1 if d == rank - 1 else e // parts if d == split else e
                for d, e in enumerate(dims))
    pad = 5 - rank
    plan = Plan(box.n, box.off, box.sn, sa, sb, b, rows, length, 1, 32, 0, 1,
                rank, parts, walk, slots, dims + (1,) * pad,
                strides + (strides[-1] * box.n,) * pad, sub + (1,) * pad,
                parts, box.n // walk, 1)
    if bulk_smem(plan) > MAX_SMEM:
        raise ValueError(f"box_copy kernel: {box} needs "
                         f"{bulk_smem(plan)} bytes of shared memory")
    return plan


def bulk_smem(plan: Plan) -> int:
    """A bulk block's shared memory: its barriers, then its ring."""
    return 128 + plan.slots * -(-2 * int(np.prod(plan.box)) // 128) * 128


# ---------------------------------------------------------------------------
# plain versions


def box_plain(src: torch.Tensor, box: Box) -> torch.Tensor:
    """The box as a gather by the kernel's index arithmetic."""
    dev = src.device
    i, j, k, e = (torch.arange(m, device=dev) for m in
                  (box.n, box.a, box.b, box.length))
    idx = (box.off + i[:, None, None, None] * box.sn
           + j[None, :, None, None] * box.sa
           + k[None, None, :, None] * box.sb + e[None, None, None, :])
    return src.reshape(-1)[idx]


def views27(sample: torch.Tensor) -> torch.Tensor:
    """X27 [216, 864] of one [8, 8, 8, 32] sample: the 27 shifted 6^3
    views, each [216, 32], concatenated along the lanes (probe_mosaic.py
    :111-117)."""
    return torch.cat([sample[kd:kd + V, kh:kh + V, kw:kw + V].reshape(-1, C)
                      for kd, kh, kw in TAPS], dim=1)


def im2col27_plain(x: torch.Tensor) -> torch.Tensor:
    return views27(x[-1])


def gram27_plain(x: torch.Tensor) -> torch.Tensor:
    """sum over samples of views[0]^T @ X27, f32 [32, 864]."""
    out = torch.zeros((C, 27 * C), dtype=torch.float32, device=x.device)
    for s in range(x.shape[0]):
        v = views27(x[s]).float()
        out += v[:, :C].T @ v
    return out


def x27_fwd(xt: torch.Tensor) -> torch.Tensor:
    """[n, 432, 128]: row tap*16 + ci, column (dd*8 + h)*8 + w, the views
    xt[:, ci, dd, kh + h, kw + w] (probe_mosaic2.py:69-75; every kd reads
    the same xt)."""
    n = xt.shape[0]
    return torch.cat([xt[:, :, :, kh:kh + H, kw:kw + W].reshape(n, CI, -1)
                      for _, kh, kw in TAPS], dim=1)


def wide_fwd_plain(w2: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    return (w2.float() @ x27_fwd(xt).float()).to(xt.dtype)


# ---------------------------------------------------------------------------
# kernels


class _CPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int * 5 if name in ("dims", "box")
                 else ctypes.c_int * 4 if name == "strides" else ctypes.c_int)
                for name in Plan._fields]


@functools.lru_cache(maxsize=None)
def _cplan(plan: Plan) -> _CPlan:
    return _CPlan(*plan)


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cuda_build.load("probe_ladder")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.ladder_box.argtypes = [p, p, p, p]
            lib.ladder_im2col.argtypes = [p, p, i, p]
            lib.ladder_gram.argtypes = [p, p, i, i, p]
            lib.ladder_wide_fwd.argtypes = [p, p, p, i, p]
            for fn in (lib.ladder_box, lib.ladder_im2col, lib.ladder_gram,
                       lib.ladder_wide_fwd):
                fn.restype = i
            _lib = lib
    return _lib


def _check(kernel: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.bfloat16 \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel: want contiguous, 16-byte "
                             f"aligned bf16 CUDA tensors; got {t.dtype} on "
                             f"{t.device}")


def _call(kernel: str, fn, *args) -> None:
    with torch.cuda.device(args[0].device):
        err = fn(*(ctypes.c_void_p(a.data_ptr())
                   if isinstance(a, torch.Tensor) else a for a in args),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    launches[kernel] += 1


def box_copy_cuda(src: torch.Tensor, box: Box, walk: int = 1,
                  slots: int = 1, bulk: bool = False) -> torch.Tensor:
    """[n, a, b, length] copy of the box on its ``box_plan``: direct loads,
    or bulk copies into a ring of ``slots`` slots with each block walking
    ``walk`` samples."""
    return box_copy_on(src, box, box_plan(box, walk, slots, bulk))


def box_copy_on(src: torch.Tensor, box: Box, plan: Plan) -> torch.Tensor:
    """The box copied by the kernel on ``plan`` (box_plan's, or one of its
    variants for a measurement)."""
    _check("box_copy", src)
    last = (box.off + (box.n - 1) * box.sn + (box.a - 1) * box.sa
            + (box.b - 1) * box.sb + box.length)
    if min(box.off, box.sn, box.sa, box.sb) < 0 or last > src.numel():
        raise ValueError(f"box_copy kernel: {box} leaves the source "
                         f"({src.numel()} values)")
    out = torch.empty((box.n, box.a, box.b, box.length), dtype=src.dtype,
                      device=src.device)
    _call("box_copy", _load().ladder_box, src, out,
          ctypes.byref(_cplan(plan)))
    return out


def im2col27_units() -> Tuple[np.ndarray, np.ndarray]:
    """im2col27_kernel's launch on blocks of IM2COL_ROWS output rows, in
    the kernel's own index arithmetic: (dst, src), each [blocks, 108,
    rows], the 16-byte unit of the output [216, 864] that thread t of
    block b stores as its i-th and the unit of the sample [8, 8, 8, 32] it
    loads for it."""
    rows = IM2COL_ROWS
    units = 27 * C // 8
    b, t, i = np.meshgrid(np.arange(V ** 3 // rows), np.arange(units),
                          np.arange(rows), indexing="ij")
    r0 = b * rows
    d, h, w = r0 // (V * V), (r0 // V) % V, r0 % V
    tap = t // 4
    kd, kh, kw = tap // 9, (tap // 3) % 3, tap % 3
    src = (((d + kd) * S + h + kh) * S + w + kw) * (C // 8) + t % 4 \
        + i * (C // 8)
    dst = r0 * units + t + i * units
    return dst, src


def im2col27_cuda(x: torch.Tensor) -> torch.Tensor:
    """X27 [216, 864] of the last sample of x [n, 8, 8, 8, 32]."""
    _check("im2col27", x)
    if tuple(x.shape[1:]) != (S, S, S, C):
        raise ValueError(f"im2col27 kernel: x {tuple(x.shape)} is not "
                         f"[n, {S}, {S}, {S}, {C}]")
    out = torch.empty((V ** 3, 27 * C), dtype=x.dtype, device=x.device)
    _call("im2col27", _load().ladder_im2col, x, out, x.shape[0] - 1)
    return out


def gram27_cuda(x: torch.Tensor, bulk: bool = False) -> torch.Tensor:
    """sum over the samples of x [n, 8, 8, 8, 32] of views[0]^T @ X27,
    f32 [32, 864]."""
    _check("gram27", x)
    if tuple(x.shape[1:]) != (S, S, S, C):
        raise ValueError(f"gram27 kernel: x {tuple(x.shape)} is not "
                         f"[n, {S}, {S}, {S}, {C}]")
    out = torch.empty((C, 27 * C), dtype=torch.float32, device=x.device)
    _call("gram27", _load().ladder_gram, x, out, x.shape[0], int(bulk))
    return out


def wide_fwd_cuda(w2: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """W2 [8, 432] @ X27 of each sample of xt [n, 16, 2, 10, 10] ->
    bf16 [n, 8, 128]."""
    _check("wide_fwd", w2, xt)
    if tuple(w2.shape) != (8, 27 * CI) \
            or tuple(xt.shape[1:]) != (CI, DD, H + 2, W + 2):
        raise ValueError(f"wide_fwd kernel: w2 {tuple(w2.shape)}, xt "
                         f"{tuple(xt.shape)}")
    out = torch.empty((xt.shape[0], 8, DD * H * W), dtype=xt.dtype,
                      device=xt.device)
    _call("wide_fwd", _load().ladder_wide_fwd, w2, xt, out, xt.shape[0])
    return out


def _dispatch(cuda_fn: Callable, plain_fn: Callable, plain: bool,
              t: torch.Tensor) -> Callable:
    if plain or t.device.type == "cpu":
        return plain_fn
    if t.is_cuda:
        return cuda_fn
    raise ValueError(f"probe ladder: no implementation for device "
                     f"{t.device}")


def _box(name: str, inp: Inputs, plain: bool) -> torch.Tensor:
    src_name, box, walk, slots, bulk = BOX_RUNGS[name]
    src = getattr(inp, src_name)
    return _dispatch(lambda: box_copy_cuda(src, box, walk, slots, bulk),
                     lambda: box_plain(src, box), plain, src)()


# ---------------------------------------------------------------------------
# the rungs

# The rungs that copy a box: (their source in Inputs, the box, walk,
# slots, bulk).
BOX_RUNGS: Dict[str, Tuple[str, Box, int, int, bool]] = {
    "copy": ("x", WHOLE, 1, 1, False),
    "cost_estimate": ("x", WHOLE, 1, 1, False),
    "manual_dma": ("x", WHOLE, 1, 1, True),
    # each sample into slot i % 2 of a 2-slot ring
    "dma_dyn_slot": ("x", WHOLE, 1, 2, True),
    # the start guarded (one thread issues it), the wait unguarded
    "dma_when_guard": ("x", WHOLE, 1, 1, True),
    "dma_pds_src": ("x", PDS, 1, 1, True),
    "dma_pds_src_offset": ("x", PDS_OFF, 1, 1, True),
    # one block walks both samples, the next one's copy in flight
    "dma_double_buffer": ("x", PDS, N, 2, True),
    "lane_value_slice": ("xt", LANE, 1, 1, False),
    "minor_slice_reshape": ("xt", RESH, 1, 1, False),
}


def t_copy(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _box("copy", inp, plain).reshape(inp.x.shape)


def t_cost(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _box("cost_estimate", inp, plain).reshape(inp.x.shape)


def t_dma(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _box("manual_dma", inp, plain).reshape(inp.x.shape)


def t_dslot(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _box("dma_dyn_slot", inp, plain).reshape(inp.x.shape)


def t_when(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _box("dma_when_guard", inp, plain).reshape(inp.x.shape)


def t_pds(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _box("dma_pds_src", inp, plain).reshape(N, 6, 6, S, C)


def t_pds_off(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _box("dma_pds_src_offset", inp, plain).reshape(N, 6, 6, 6, C)


def t_dma2(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _box("dma_double_buffer", inp, plain).reshape(N, 6, 6, S, C)


def t_concat(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _dispatch(lambda: im2col27_cuda(inp.x),
                     lambda: im2col27_plain(inp.x), plain, inp.x)()


def t_dot(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _dispatch(lambda: gram27_cuda(inp.x),
                     lambda: gram27_plain(inp.x), plain, inp.x)()


def t_full(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _dispatch(lambda: gram27_cuda(inp.x, bulk=True),
                     lambda: gram27_plain(inp.x), plain, inp.x)()


def t_lane(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _box("lane_value_slice", inp, plain).reshape(2, CI, DD, H + 2, W)


def t_resh(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _box("minor_slice_reshape", inp, plain).reshape(CI, DD * H * W)


def t_fwd(inp: Inputs, plain: bool = False) -> torch.Tensor:
    return _dispatch(lambda: wide_fwd_cuda(inp.w2, inp.xt),
                     lambda: wide_fwd_plain(inp.w2, inp.xt), plain, inp.xt)()


# (name as the scripts print it, rung, its kernel)
RUNGS: Tuple[Tuple[str, Callable, str], ...] = (
    ("copy", t_copy, "box_copy"),
    ("cost_estimate", t_cost, "box_copy"),
    ("manual_dma", t_dma, "box_copy"),
    ("dma_dyn_slot", t_dslot, "box_copy"),
    ("dma_when_guard", t_when, "box_copy"),
    ("dma_pds_src", t_pds, "box_copy"),
    ("dma_pds_src_offset", t_pds_off, "box_copy"),
    ("dma_double_buffer", t_dma2, "box_copy"),
    ("lane_concat27", t_concat, "im2col27"),
    ("wide_dot_accum", t_dot, "gram27"),
    ("dw_skeleton", t_full, "gram27"),
    ("lane_value_slice", t_lane, "box_copy"),
    ("minor_slice_reshape", t_resh, "box_copy"),
    ("wide_fwd_skeleton", t_fwd, "wide_fwd"),
)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / max(want.float().abs().max().item(), 1e-30)


def checked(rung: Callable, kernel: str, inp: Inputs) -> torch.Tensor:
    """The rung's output, held against its plain version (TOL)."""
    got = rung(inp)
    want = rung(inp, plain=True)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} != plain "
                             f"{tuple(want.shape)} {want.dtype}")
    rel = rel_err(got, want)[1]
    if not rel <= TOL[kernel]:
        raise AssertionError(f"relative error {rel:.3e} > {TOL[kernel]:.0e}")
    return got


def run(name: str, fn: Callable[[], torch.Tensor]) -> bool:
    """Run one rung; print ``name OK (first value)`` or ``name FAIL ...``
    and go on (probe_mosaic.py:23-35)."""
    try:
        out = fn()
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        val = float(out.reshape(-1)[0].float())
        print(f"{name:28s} OK   ({val:.3f})", flush=True)
        return True
    except Exception as e:  # noqa: BLE001 — report and continue
        msg = str(e).replace("\n", " | ")[:300]
        print(f"{name:28s} FAIL {type(e).__name__}: {msg}", flush=True)
        return False


def run_all(inp: Inputs) -> Dict[str, bool]:
    """Every rung, each checked against its plain version."""
    return {name: run(name, lambda rung=rung, k=kernel: checked(rung, k, inp))
            for name, rung, kernel in RUNGS}


def main() -> int:
    device = resolve_device("")
    print(f"# device={torch.cuda.get_device_name(device)}", flush=True)
    results = run_all(inputs(device))
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

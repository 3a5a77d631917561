"""The k3 conv kernels: tiling, binding and autograd wrappers.

The kernels live in ``gan3d_tpu_torch/csrc/conv3d_k3.cu`` and
``csrc/conv3d_toeplitz.cu`` (their headers say which TPU kernels they
replace and what bounds them); ``ops/cuda_build.py`` compiles them at
first use and they are called through ``ctypes`` on PyTorch's current
stream:

- ``wide_conv3d_cuda(x, w)``: the wide-N k3/s1/p1 conv (K4), used for the
  forward and, with spatially flipped, in/out-swapped weights, for dx. Two
  routes by dtype: bf16 goes to the tensor-core implicit GEMM
  (``wide_tc_kernel``, on the weight as ``repack_weight_cuda`` lays it
  out; ``repack_weight`` is its plain version), f32 to the 3xTF32 implicit
  GEMM on the tensor cores (``wide_tf32x3_kernel``, on the weight split
  into its TF32 halves as ``repack_weight_x3_cuda`` lays it out;
  ``repack_weight_x3`` is its plain version); any other dtype raises;
- ``conv3d_dw_cuda(x, g)``: its weight gradient (K3), split-K partials
  summed in a fixed order by a second kernel, so a repeated dW is
  bit-identical. Two routes by dtype, both implicit GEMMs over the
  positions on the tensor cores: bf16 goes to ``dw_tc_kernel``, f32 to
  the 3xTF32 ``dw_tf32x3_kernel``;
- ``toeplitz_conv3d_cuda(x, w)``: the direct k3/s1/p1 conv in the JAX
  op's channels-last layout (K5), the conv of ``ops/toeplitz_conv.py``.
  Two routes by dtype: bf16 goes to the tensor-core implicit GEMM
  (``toeplitz_tc_kernel``, on the weight as ``repack_toeplitz_weight_cuda``
  lays it out; ``repack_toeplitz_weight`` is its plain version), f32 to
  the 3xTF32 one (``toeplitz_tf32x3_kernel``, on the weight as
  ``repack_toeplitz_weight_x3_cuda`` lays it out;
  ``repack_toeplitz_weight_x3`` is its plain version).

The tiling of each launch (``wide_x3_plan``, ``wide_tc_plan``,
``dw_x3_plan``, ``dw_tc_plan``, ``toeplitz_x3_plan``, ``toeplitz_tc_plan``)
is chosen here, so the CPU tests reach it. Two ``autograd.Function``s
carry the routes of ``ops/conv3d.conv3d``, counterparts of the JAX custom
VJPs (K5's is ``ops/toeplitz_conv.py:ToeplitzConv3d``):
- ``WideConv3d`` (wide_conv.py:190-210): forward K4, dx K4, dW K3 cast to
  w's dtype;
- ``Conv3dK3Dw`` (dw_conv.py:227-253): forward ``F.conv3d`` and dx the
  plain input-gradient conv (the JAX package leaves both to XLA), dW K3.
On a CPU tensor both run the plain versions of ``ops/conv3d.py`` in the
kernels' place; on a CUDA tensor they run the kernels, which raise on a
dtype or shape they do not take. Nothing falls back.

``wide_launches`` / ``dw_launches`` / ``toeplitz_launches`` (f32 routes)
and ``wide_tc_launches`` / ``dw_tc_launches`` / ``toeplitz_tc_launches``
(bf16 routes) count the wrappers' launches.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gan3d_tpu_torch.ops import cuda_build
from gan3d_tpu_torch.ops.conv3d import conv3d_dw_plain, conv3d_k3_plain
from gan3d_tpu_torch.ops.cuda_build import SMS

_DTYPES = (torch.float32, torch.bfloat16)
TC_CI = 16                 # K4, K5 bf16: input channels per stage (kTcCi)
TC_CO_PAD = 64             # K4, K5 bf16: repacked Co multiple (csrc kTcCoPad)
DW_CI, DW_CO = 16, 32      # K3: channels per block (csrc kDwCi / kDwCo;
                           # the bf16 route's kDwTcCi / kDwTcCo too)
DW_BLOCKS_PER_SM = 2       # K3 bf16: resident blocks per SM
DW_TC_BOX = 512            # K3 bf16: most positions per staged box
DW_X3_BOX = 256            # K3 f32: most positions per staged box
DW_X3_CHAIN = 2048         # K3 f32: most positions an MMA chain sums in the
                           # tensor cores (csrc kDwX3Chain)
TOEPLITZ_TC_WARPS = 8      # K5 bf16: warps per block (csrc kTcThreads / 32)
TOEPLITZ_TC_SMEM = 113 << 10  # K5 bf16: shared memory of one of 2 blocks/SM
X3_WARPS = 8               # K4, K5 f32: warps per block (csrc kX3Threads / 32)
X3_CI = 8                  # K4, K5 f32: input channels a chunk (csrc kX3Ci)
X3_CHUNKS = 9              # K4, K5 f32: most chunks a split-K part sums in
                           # the tensor cores (csrc kX3Chunks: 1944 terms)
WIDE_X3_CO_PAD = 128       # K4 f32: repacked Co multiple (csrc kX3CoPad)
TOEPLITZ_X3_CO_PAD = 64    # K5 f32: repacked Co multiple (csrc kX3CoPad)
SMEM_MAX = 227 << 10       # shared memory a block can have (sm_90)

wide_launches = 0
wide_tc_launches = 0
dw_launches = 0
dw_tc_launches = 0
toeplitz_launches = 0
toeplitz_tc_launches = 0

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def reset_counters() -> None:
    global wide_launches, wide_tc_launches, dw_launches, dw_tc_launches
    global toeplitz_launches, toeplitz_tc_launches
    wide_launches = 0
    wide_tc_launches = 0
    dw_launches = 0
    dw_tc_launches = 0
    toeplitz_launches = 0
    toeplitz_tc_launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wide_x3_smem(td: int, th: int, tw: int, wm: int) -> int:
    """Shared-memory bytes of a K4 f32 block (csrc launch_wide_x3): two
    x stages of X3_CI channels (td planes of th + 2 rows of tw + 8 floats a
    channel, csrc x3_cs) and two weight stages (hi and lo halves of 9 taps
    x 32*wm channels x X3_CI)."""
    cs = ((td * (th + 2) * (tw + 8) + 7) & ~7) + 4
    return 4 * X3_CI * (2 * cs + 2 * 2 * 9 * 32 * wm)


def _x3_parts(chunks: int, blocks: int) -> int:
    """Split-K parts of the f32 routes: enough that none sums more than
    X3_CHUNKS chunks in the tensor cores, whose f32 sums are not rounded to
    nearest, and where ``blocks`` (the grid of one part) is fewer than the
    card's SMs, enough to cover it about twice."""
    p = _cdiv(chunks, X3_CHUNKS)
    if blocks * p < SMS:
        p = min(chunks, max(p, _cdiv(2 * SMS, blocks)))
    return p


def wide_x3_plan(n: int, ci: int, co: int, d: int, h: int, w: int
                 ) -> Tuple[int, int, int, int, int]:
    """K4 f32 tiling (td, th, tw, wm, P): a block of X3_WARPS warps
    computes 32*wm output channels x a td x th x tw box of one sample, at
    most 64*(8 // wm) positions (w fastest, up to 32 along w): wm = 1 for
    Co <= 32, 4 for Co >= 128 on volumes of at most 128 positions (whose
    boxes would leave most 64-position warps idle), else 2. Planes, then
    rows, are halved while the block's shared memory exceeds SMEM_MAX;
    the Ci/8 chunks are split into P parts (``_x3_parts``)."""
    wm = 1 if co <= 32 else 4 if co >= 128 and d * h * w <= 128 else 2
    bn = 64 * (X3_WARPS // wm)
    tw = min(w, 32)
    th = min(h, max(1, bn // tw))
    td = min(d, max(1, bn // (tw * th)))
    while (td > 1 or th > 1) and wide_x3_smem(td, th, tw, wm) > SMEM_MAX:
        if td > 1:
            td = _cdiv(td, 2)
        else:
            th = _cdiv(th, 2)
    blocks = (n * _cdiv(d, td) * _cdiv(h, th) * _cdiv(w, tw)
              * _cdiv(co, 32 * wm))
    return td, th, tw, wm, _x3_parts(_cdiv(ci, X3_CI), blocks)


def wide_tc_plan(n: int, ci: int, co: int, d: int, h: int, w: int
                 ) -> Tuple[int, int, int, int, int]:
    """K4 bf16 tiling (td, th, tw, wm, P): a block of 4 warps computes
    32*wm output channels (wm = 1 for Co <= 32, else 2) x a td x th x tw
    box of one sample, at most 64*(4 // wm) positions (w fastest, up to 32
    along w). Where boxes x Co tiles give fewer blocks than the card has
    SMs, the Ci/16 channel stages are split into P parts (split-K) so that
    the grid covers the card about twice. The kernel picks its staging from
    W and tw."""
    wm = 1 if co <= 32 else 2
    bn = 64 * (4 // wm)
    tw = min(w, 32)
    th = min(h, max(1, bn // tw))
    td = min(d, max(1, bn // (tw * th)))
    blocks = (n * _cdiv(d, td) * _cdiv(h, th) * _cdiv(w, tw)
              * _cdiv(co, 32 * wm))
    p = 1 if blocks >= SMS else min(_cdiv(ci, TC_CI), _cdiv(2 * SMS, blocks))
    return td, th, tw, wm, p


def repack_weight(w: torch.Tensor) -> torch.Tensor:
    """w [Co, Ci, 3, 3, 3] -> the K4 bf16 kernel's [Ci/16, 27, Cop, 16]
    (tap = kd*9 + kh*3 + kw; Ci and Co zero-padded to multiples of 16 and
    64): chunk c, tap t holds the A operand W[co, 16c + i, t] of that
    k-step, 16 contiguous input channels per output channel. The plain
    version of ``repack_weight_cuda``."""
    co, ci = w.shape[:2]
    cip, cop = _cdiv(ci, TC_CI) * TC_CI, _cdiv(co, TC_CO_PAD) * TC_CO_PAD
    wp = F.pad(w.reshape(co, ci, 27), (0, 0, 0, cip - ci, 0, cop - co))
    return (wp.reshape(cop, cip // TC_CI, TC_CI, 27).permute(1, 3, 0, 2)
            .contiguous())


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of an f32 tensor as the f32 routes' kernels split it
    (csrc/mma_tf32.cuh split_tf32): hi is x rounded to TF32 to nearest,
    ties away from zero (half a TF32 ulp added to the magnitude's bit
    pattern, its 13 low bits cleared), lo the same rounding of x - hi."""
    def rna(v):
        return ((v.view(torch.int32) + 0x1000) & -8192).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def repack_weight_x3(w: torch.Tensor) -> torch.Tensor:
    """w [Co, Ci, 3, 3, 3] f32 -> the K4 f32 kernel's [2, Ci/8, 27, Cop, 8]
    (Ci and Co zero-padded to multiples of 8 and WIDE_X3_CO_PAD): [0, c, t,
    co, i] is the hi TF32 half of W[co, 8c + i, t], [1, c, t, co, i] its lo
    half (``split_tf32``). The plain version of ``repack_weight_x3_cuda``."""
    co, ci = w.shape[:2]
    cip = _cdiv(ci, X3_CI) * X3_CI
    cop = _cdiv(co, WIDE_X3_CO_PAD) * WIDE_X3_CO_PAD
    wp = F.pad(w.reshape(co, ci, 27), (0, 0, 0, cip - ci, 0, cop - co))
    wp = wp.reshape(cop, cip // X3_CI, X3_CI, 27).permute(1, 3, 0, 2)
    return torch.stack(split_tf32(wp.contiguous()))


def dw_x3_smem(td: int, th: int, tw: int) -> int:
    """Shared-memory bytes of a K3 f32 block (csrc dw_x3_smem): two stages
    of DW_CI x channels (the halo box's (td + 2) x (th + 2) rows of tw + 8
    floats, rounded up to 4 mod 8) and DW_CO g rows (the box rounded up to
    8 positions, + 4 floats), the halo-row table, and at least the
    epilogue's DW_CO x (27 * DW_CI + 1) output tile."""
    kp = _cdiv(td * th * tw, 8) * 8
    cs = (((td + 2) * (th + 2) * (tw + 8) + 7) & ~7) + 4
    stage = DW_CI * cs + DW_CO * (kp + 4)
    return max(4 * (2 * stage + kp), 4 * DW_CO * (27 * DW_CI + 1))


def dw_x3_plan(n: int, ci: int, co: int, d: int, h: int, w: int
               ) -> Tuple[int, int, int, int]:
    """K3 f32 tiling (td, th, tw, P): boxes of up to DW_X3_BOX positions
    (tw a multiple of 4 up to 32 along w, the positions past W zero; th
    and td about equal, so the halo stays small), planes, then rows,
    halved while the block's shared memory exceeds SMEM_MAX, then evened
    out over the volume; blocks of
    DW_CO output x DW_CI input channels, one an SM; and P split-K chunks of
    the N x boxes list, as many as give about two blocks an SM over the
    grid. A chain of MMAs sums DW_X3_CHAIN // (box rounded up to 8) boxes
    at most, then a running f32 sum takes it, so P is free of the sum's
    length."""
    tw = min(_cdiv(w, 4) * 4, 32)
    rest = DW_X3_BOX // tw
    th = min(h, 1 << (math.isqrt(rest).bit_length() - 1))
    td = min(d, max(1, rest // th))
    th = min(h, max(1, rest // td))
    while (td > 1 or th > 1) and dw_x3_smem(td, th, tw) > SMEM_MAX:
        if td > 1:
            td = _cdiv(td, 2)
        else:
            th = _cdiv(th, 2)
    td, th = _cdiv(d, _cdiv(d, td)), _cdiv(h, _cdiv(h, th))  # even boxes
    boxes = n * _cdiv(d, td) * _cdiv(h, th) * _cdiv(w, tw)
    tiles = _cdiv(ci, DW_CI) * _cdiv(co, DW_CO)
    return td, th, tw, max(1, min(boxes, round(2 * SMS / tiles)))


def dw_tc_plan(n: int, ci: int, co: int, d: int, h: int, w: int
               ) -> Tuple[int, int, int, int]:
    """K3 bf16 tiling (td, th, tw, P): boxes of up to DW_TC_BOX
    positions (tw up to 32 along w, th and td about equal, so the halo
    stays small), blocks of DW_CO output x DW_CI input channels, and P
    split-K chunks of the N x boxes list: as many as the card holds at
    once (DW_BLOCKS_PER_SM a SM), so the grid runs in one wave."""
    tw = min(w, 32)
    rest = DW_TC_BOX // tw
    th = min(h, 1 << (math.isqrt(rest).bit_length() - 1))
    td = min(d, max(1, rest // th))
    th = min(h, max(1, rest // td))
    boxes = n * _cdiv(d, td) * _cdiv(h, th) * _cdiv(w, tw)
    tiles = _cdiv(ci, DW_CI) * _cdiv(co, DW_CO)
    p = max(1, min(boxes, DW_BLOCKS_PER_SM * SMS // tiles))
    return td, th, tw, p


def dw_tc_smem(td: int, th: int, tw: int) -> int:
    """Shared-memory bytes of a K3 bf16 block (csrc launch_dw_tc): the x
    halo box (32 bytes a row), the g box (64 bytes a position, rounded up
    to 16 positions) and its halo-row table."""
    kpad = _cdiv(td * th * tw, 16) * 16
    return 32 * (td + 2) * (th + 2) * (tw + 2) + (64 + 4) * kpad


def toeplitz_x3_smem(bh: int, bw: int, wn: int) -> int:
    """Shared-memory bytes of a K5 f32 block (csrc launch_x3): two x
    stages of the plane's (bh + 2) x (bw + 2) halo rows of X3_CI floats
    and two weight stages (hi and lo halves of 9 taps x 32*wn channels x
    X3_CI)."""
    return 4 * X3_CI * (2 * (bh + 2) * (bw + 2) + 2 * 2 * 9 * 32 * wn)


def toeplitz_x3_plan(n: int, d: int, h: int, w: int, ci: int, co: int
                     ) -> Tuple[int, int, int, int]:
    """K5 f32 tiling (bh, bw, wn, P): toeplitz_tc_plan's block (X3_WARPS
    warps, 32*wn output channels x bh rows x bw columns of one (n, d), at
    most 64 * (8 // wn) positions), rows halved while its shared memory
    exceeds SMEM_MAX; the Ci/8 chunks are split into P parts
    (``_x3_parts``)."""
    wn = 1 if co <= 32 else 2
    bw = min(w, 32)
    bh = min(h, max(1, 64 * (X3_WARPS // wn) // bw))
    while bh > 1 and toeplitz_x3_smem(bh, bw, wn) > SMEM_MAX:
        bh = _cdiv(bh, 2)
    blocks = n * d * _cdiv(h, bh) * _cdiv(w, bw) * _cdiv(co, 32 * wn)
    return bh, bw, wn, _x3_parts(_cdiv(ci, X3_CI), blocks)


def toeplitz_tc_smem(bh: int, bw: int, wn: int) -> int:
    """Shared-memory bytes of a K5 bf16 block (csrc launch_tc): the
    3-plane halo box and the stage's weights, 32 bytes a row."""
    return 32 * (3 * (bh + 2) * (bw + 2) + 27 * 32 * wn)


def toeplitz_tc_plan(n: int, d: int, h: int, w: int, co: int
                     ) -> Tuple[int, int, int]:
    """K5 bf16 tiling (bh, bw, wn): a block of TOEPLITZ_TC_WARPS warps
    computes 32*wn output channels (wn = 1 for Co <= 32, else 2) x bh rows
    x bw columns (up to 32) of one (n, d), at most 64 * (8 // wn)
    positions, rows halved while its shared memory would keep two blocks
    off one SM (TOEPLITZ_TC_SMEM)."""
    wn = 1 if co <= 32 else 2
    bw = min(w, 32)
    bh = min(h, max(1, 64 * (TOEPLITZ_TC_WARPS // wn) // bw))
    while bh > 1 and toeplitz_tc_smem(bh, bw, wn) > TOEPLITZ_TC_SMEM:
        bh = _cdiv(bh, 2)
    return bh, bw, wn


def repack_toeplitz_weight(w: torch.Tensor) -> torch.Tensor:
    """w [3, 3, 3, Ci, Co] (DHWIO) -> the K5 bf16 kernel's [Ci/16, 27,
    Cop, 16] (tap = a*9 + b*3 + c; Ci and Co zero-padded to multiples of 16
    and 64): chunk k, tap t holds the B operand w[t, 16k + i, co] of that
    k-step, 16 contiguous input channels per output channel. The plain
    version of ``repack_toeplitz_weight_cuda``."""
    ci, co = w.shape[3:]
    cip, cop = _cdiv(ci, TC_CI) * TC_CI, _cdiv(co, TC_CO_PAD) * TC_CO_PAD
    wp = F.pad(w.reshape(27, ci, co), (0, cop - co, 0, cip - ci))
    return (wp.reshape(27, cip // TC_CI, TC_CI, cop).permute(1, 0, 3, 2)
            .contiguous())


def repack_toeplitz_weight_x3(w: torch.Tensor) -> torch.Tensor:
    """w [3, 3, 3, Ci, Co] (DHWIO) f32 -> the K5 f32 kernel's [2, Ci/8, 27,
    Cop, 8] (Ci and Co zero-padded to multiples of 8 and
    TOEPLITZ_X3_CO_PAD): [0, k, t, co, i] is the hi TF32 half of
    w[t, 8k + i, co], [1, k, t, co, i] its lo half (``split_tf32``). The
    plain version of ``repack_toeplitz_weight_x3_cuda``."""
    ci, co = w.shape[3:]
    cip = _cdiv(ci, X3_CI) * X3_CI
    cop = _cdiv(co, TOEPLITZ_X3_CO_PAD) * TOEPLITZ_X3_CO_PAD
    wp = F.pad(w.reshape(27, ci, co), (0, cop - co, 0, cip - ci))
    wp = wp.reshape(27, cip // X3_CI, X3_CI, cop).permute(1, 0, 3, 2)
    return torch.stack(split_tf32(wp.contiguous()))


# library -> entry point -> (pointer arguments, int arguments); each entry
# point also takes the stream and returns a cudaError_t.
_SIGNATURES = {"conv3d_k3": {"k3_wide_x3": (4, 11), "k3_wide_tc": (4, 11),
                              "k3_repack": (2, 2), "k3_repack_x3": (2, 2),
                              "k3_dw_x3": (4, 10), "k3_dw_tc": (4, 10)},
               "conv3d_toeplitz": {"k3_toeplitz_x3": (4, 10),
                                   "k3_toeplitz_repack": (2, 2),
                                   "k3_toeplitz_repack_x3": (2, 2),
                                   "k3_toeplitz_tc": (3, 9)}}


def _load(name: str) -> ctypes.CDLL:
    with _lib_lock:
        if name not in _libs:
            lib = cuda_build.load(name)
            p, i = ctypes.c_void_p, ctypes.c_int
            for entry, (ptrs, ints) in _SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = [p] * ptrs + [i] * ints + [p]
                fn.restype = i
            _libs[name] = lib
    return _libs[name]


def _check(x: torch.Tensor, other: torch.Tensor, name: str) -> None:
    """Raise ValueError unless the kernels take x and ``other`` (the weight
    or the output gradient) as given."""
    for what, t in (("input", x), (name, other)):
        if not t.is_cuda:
            raise ValueError(f"k3 conv kernel: {what} is on {t.device}, not "
                             "a CUDA device")
        if t.dtype not in _DTYPES:
            raise ValueError(f"k3 conv kernel: {what} dtype {t.dtype} not in "
                             "(float32, bfloat16)")
        if t.dim() != 5 or not t.is_contiguous() or t.numel() == 0:
            raise ValueError(f"k3 conv kernel: {what} must be a contiguous, "
                             f"non-empty 5-d tensor; got {tuple(t.shape)}")
    if x.dtype != other.dtype or x.device != other.device:
        raise ValueError(f"k3 conv kernel: input and {name} differ in dtype "
                         f"or device: {x.dtype}/{other.dtype}, {x.device}/"
                         f"{other.device}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_if(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"k3 conv {what} kernel launch failed: "
                           f"cudaError {err}")


def repack_weight_cuda(w: torch.Tensor) -> torch.Tensor:
    """``repack_weight`` of a contiguous bf16 CUDA weight by one kernel
    launch (part of each K4 bf16 call, so not counted apart)."""
    co, ci = w.shape[:2]
    wp = torch.empty((_cdiv(ci, TC_CI), 27, _cdiv(co, TC_CO_PAD) * TC_CO_PAD,
                      TC_CI), dtype=torch.bfloat16, device=w.device)
    with torch.cuda.device(w.device):
        err = _load("conv3d_k3").k3_repack(_ptr(w), _ptr(wp), co, ci,
                                           _stream(w))
    _raise_if(err, "weight repack")
    return wp


def repack_weight_x3_cuda(w: torch.Tensor) -> torch.Tensor:
    """``repack_weight_x3`` of a contiguous f32 CUDA weight by one kernel
    launch (part of each K4 f32 call, so not counted apart)."""
    co, ci = w.shape[:2]
    wp = torch.empty((2, _cdiv(ci, X3_CI), 27,
                      _cdiv(co, WIDE_X3_CO_PAD) * WIDE_X3_CO_PAD, X3_CI),
                     dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        err = _load("conv3d_k3").k3_repack_x3(_ptr(w), _ptr(wp), co, ci,
                                              _stream(w))
    _raise_if(err, "weight split")
    return wp


def wide_conv3d_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K4: k3/s1/p1 conv of x [N,Ci,D,H,W] with w [Co,Ci,3,3,3] (same
    dtype), f32 accumulation; [N,Co,D,H,W] in x's dtype. Both dtypes run
    on the tensor cores, f32 in 3xTF32."""
    global wide_launches, wide_tc_launches
    x, w = x.contiguous(), w.contiguous()
    _check(x, w, "weight")
    n, ci, d, h, wd = x.shape
    co = w.shape[0]
    if tuple(w.shape) != (co, ci, 3, 3, 3) or min(ci, co) < 8:
        raise ValueError(f"wide conv kernel: weight {tuple(w.shape)} is not "
                         f"[Co, {ci}, 3, 3, 3] with Ci, Co >= 8 (the "
                         "dispatcher's rule)")
    out = torch.empty((n, co, d, h, wd), dtype=x.dtype, device=x.device)
    lib = _load("conv3d_k3")
    if x.dtype == torch.bfloat16:
        td, th, tw, wm, p = wide_tc_plan(n, ci, co, d, h, wd)
        wp = repack_weight_cuda(w)
        part = (torch.empty((p, n, co, d * h * wd), dtype=torch.float32,
                            device=x.device) if p > 1 else out)
        with torch.cuda.device(x.device):
            err = lib.k3_wide_tc(_ptr(x), _ptr(wp), _ptr(part), _ptr(out), n,
                                 ci, co, d, h, wd, td, th, tw, wm, p,
                                 _stream(x))
        _raise_if(err, "wide (bf16)")
        wide_tc_launches += 1
        return out
    td, th, tw, wm, p = wide_x3_plan(n, ci, co, d, h, wd)
    wp = repack_weight_x3_cuda(w)
    part = (torch.empty((p, n, co, d * h * wd), dtype=torch.float32,
                        device=x.device) if p > 1 else out)
    with torch.cuda.device(x.device):
        err = lib.k3_wide_x3(_ptr(x), _ptr(wp), _ptr(part), _ptr(out), n, ci,
                             co, d, h, wd, td, th, tw, wm, p, _stream(x))
    _raise_if(err, "wide (f32)")
    wide_launches += 1
    return out


def conv3d_dw_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K3: dW of a k3/s1/p1 conv from its input x [N,Ci,D,H,W] and output
    gradient g [N,Co,D,H,W] (same dtype): f32 [Co, Ci, 3, 3, 3]. Both
    dtypes run on the tensor cores, f32 in 3xTF32."""
    global dw_launches, dw_tc_launches
    x, g = x.contiguous(), g.contiguous()
    _check(x, g, "gradient")
    n, ci, d, h, wd = x.shape
    co = g.shape[1]
    if tuple(g.shape) != (n, co, d, h, wd) or min(ci, co) < 8:
        raise ValueError(f"dW kernel: gradient {tuple(g.shape)} does not "
                         f"match input {tuple(x.shape)}, or Ci or Co < 8 "
                         "(the dispatcher's rule)")
    dw = torch.empty((co, ci, 3, 3, 3), dtype=torch.float32, device=x.device)
    lib = _load("conv3d_k3")
    if x.dtype == torch.bfloat16:
        td, th, tw, p = dw_tc_plan(n, ci, co, d, h, wd)
        part = torch.empty((p, co, 27, ci), dtype=torch.float32,
                           device=x.device)
        with torch.cuda.device(x.device):
            err = lib.k3_dw_tc(_ptr(x), _ptr(g), _ptr(part), _ptr(dw), n, ci,
                               co, d, h, wd, td, th, tw, p, _stream(x))
        _raise_if(err, "dW (bf16)")
        dw_tc_launches += 1
        return dw
    td, th, tw, p = dw_x3_plan(n, ci, co, d, h, wd)
    part = (torch.empty((p, co, ci, 27), dtype=torch.float32,
                        device=x.device) if p > 1 else dw)
    with torch.cuda.device(x.device):
        err = lib.k3_dw_x3(_ptr(x), _ptr(g), _ptr(part), _ptr(dw), n, ci, co,
                           d, h, wd, td, th, tw, p, _stream(x))
    _raise_if(err, "dW (f32)")
    dw_launches += 1
    return dw


def repack_toeplitz_weight_cuda(w: torch.Tensor) -> torch.Tensor:
    """``repack_toeplitz_weight`` of a contiguous bf16 CUDA weight by one
    kernel launch (part of each K5 bf16 call, so not counted apart)."""
    ci, co = w.shape[3:]
    wp = torch.empty((_cdiv(ci, TC_CI), 27, _cdiv(co, TC_CO_PAD) * TC_CO_PAD,
                      TC_CI), dtype=torch.bfloat16, device=w.device)
    with torch.cuda.device(w.device):
        err = _load("conv3d_toeplitz").k3_toeplitz_repack(
            _ptr(w), _ptr(wp), ci, co, _stream(w))
    _raise_if(err, "toeplitz weight repack")
    return wp


def repack_toeplitz_weight_x3_cuda(w: torch.Tensor) -> torch.Tensor:
    """``repack_toeplitz_weight_x3`` of a contiguous f32 CUDA weight by one
    kernel launch (part of each K5 f32 call, so not counted apart)."""
    ci, co = w.shape[3:]
    wp = torch.empty((2, _cdiv(ci, X3_CI), 27,
                      _cdiv(co, TOEPLITZ_X3_CO_PAD) * TOEPLITZ_X3_CO_PAD,
                      X3_CI), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        err = _load("conv3d_toeplitz").k3_toeplitz_repack_x3(
            _ptr(w), _ptr(wp), ci, co, _stream(w))
    _raise_if(err, "toeplitz weight split")
    return wp


def toeplitz_conv3d_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K5: k3/s1/p1 conv of x [N,D,H,W,Ci] with w [3,3,3,Ci,Co] (same
    dtype), f32 accumulation; [N,D,H,W,Co] in x's dtype. Both dtypes run
    on the tensor cores, f32 in 3xTF32."""
    global toeplitz_launches, toeplitz_tc_launches
    x, w = x.contiguous(), w.contiguous()
    _check(x, w, "weight")
    n, d, h, wd, ci = x.shape
    co = w.shape[4]
    if tuple(w.shape) != (3, 3, 3, ci, co):
        raise ValueError(f"toeplitz conv kernel: weight {tuple(w.shape)} is "
                         f"not [3, 3, 3, {ci}, Co]")
    out = torch.empty((n, d, h, wd, co), dtype=x.dtype, device=x.device)
    lib = _load("conv3d_toeplitz")
    if x.dtype == torch.bfloat16:
        bh, bw, wn = toeplitz_tc_plan(n, d, h, wd, co)
        wp = repack_toeplitz_weight_cuda(w)
        with torch.cuda.device(x.device):
            err = lib.k3_toeplitz_tc(_ptr(x), _ptr(wp), _ptr(out), n, d, h,
                                     wd, ci, co, bh, bw, wn, _stream(x))
        _raise_if(err, "toeplitz (bf16)")
        toeplitz_tc_launches += 1
        return out
    bh, bw, wn, p = toeplitz_x3_plan(n, d, h, wd, ci, co)
    wp = repack_toeplitz_weight_x3_cuda(w)
    part = (torch.empty((p, n, d, h, wd, co), dtype=torch.float32,
                        device=x.device) if p > 1 else out)
    with torch.cuda.device(x.device):
        err = lib.k3_toeplitz_x3(_ptr(x), _ptr(wp), _ptr(part), _ptr(out), n,
                                 d, h, wd, ci, co, bh, bw, wn, p, _stream(x))
    _raise_if(err, "toeplitz (f32)")
    toeplitz_launches += 1
    return out


def _wide(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return wide_conv3d_cuda(x, w)
    if x.device.type == "cpu":
        return conv3d_k3_plain(x, w)
    raise ValueError(f"k3 conv: no implementation for device {x.device}")


def _dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return conv3d_dw_cuda(x, g)
    if x.device.type == "cpu":
        return conv3d_dw_plain(x, g)
    raise ValueError(f"k3 conv dW: no implementation for device {x.device}")


class WideConv3d(torch.autograd.Function):
    """k3/s1/p1 conv: the wide-N conv forward and dx, the dW kernel for
    dW. First-order only, like the JAX custom VJP."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _wide(x, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx of a k3/s1/p1 conv is the same conv with spatially
            # reversed, in/out-swapped weights (wide_conv.py:202-205)
            dx = _wide(g, w.flip(2, 3, 4).transpose(0, 1).to(g.dtype))
        if ctx.needs_input_grad[1]:
            dw = _dw(x, g.to(x.dtype)).to(w.dtype)
        return dx, dw


class Conv3dK3Dw(torch.autograd.Function):
    """k3/s1/p1 conv whose backward computes dW with the dW kernel; the
    forward and dx are the plain convs. First-order only."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv3d(x, w, None, 1, 1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(x.shape, w, g, 1, 1)
        if ctx.needs_input_grad[1]:
            dw = _dw(x, g.to(x.dtype)).to(w.dtype)
        return dx, dw

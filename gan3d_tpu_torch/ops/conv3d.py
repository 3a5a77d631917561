"""Convolution dispatch, the k3 convs' plain versions, and pooling helpers
(NCDHW; conv weights in torch's [Co, Ci, kd, kh, kw] layout).

``conv3d`` follows gan3d_tpu/ops/conv3d.py:64-69: an eligible conv goes to
the wide-N conv when ``wide_conv`` is on, else to the conv with the fast
weight gradient when ``fast_dw`` is on, else to ``F.conv3d``. Both modes
take ``"off" | "auto" | "on"``; ``"auto"`` means off, as in the JAX
package (wide_conv.py:60-64, dw_conv.py:79-83). The kernel routes are the
``autograd.Function``s of ``ops/cuda_conv.py``: on a CUDA tensor they run
the hand-written kernels, on a CPU tensor the plain versions below.

Eligibility is the shape rule of ``wide_conv.eligible`` /
``dw_conv.eligible``: kernel 3^3, stride 1, padding 1, dilation 1,
groups 1, Ci >= 8, Co >= 8. Their VMEM budgets (wide_conv.py:92-97,
dw_conv.py:125-129) and the fallbacks to XLA when a tile would overflow
VMEM (wide_conv.py:177-182, dw_conv.py:209-214) exist only because of the
TPU's 16 MB VMEM and are left out: the port admits every shape the JAX rule
admits, and also the three flagship shapes it turns down (32ch@64^3,
64ch@32^3 and D's 256ch@8^3). The function computed is the same either
way; only the dispatch differs.

The plain versions write out the kernels' algebra, in f32, chunked over
the batch and over depth (one sample's f32 X27 at 32ch@64^3 is 0.9 GB):
- ``conv3d_k3_plain``: out[co, s] = W2[co, 27*Ci] @ X27[27*Ci, s], with X27
  the 27 shifted views of the zero-padded input, row tap*Ci + ci (the JAX
  kernel's order, wide_conv.py:132-139);
- ``conv3d_dw_plain``: dW[co, ci, k] = sum_{n,s} g[n, co, s] x[n, ci, s+k-1]
  as G[Co, S] @ X27[27*Ci, S]^T, in f32 [Co, Ci, 3, 3, 3].

Pooling helpers: counterparts of gan3d_tpu/ops/conv3d.py:134-190.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

MODES = ("off", "auto", "on")
# Bytes of one f32 X27 chunk in the plain versions.
CHUNK_BYTES = 64 << 20

_WIDE_MODE = "auto"
_DW_MODE = "auto"


def _check_mode(name: str, mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"{name} mode {mode!r} not in {MODES}")
    return mode


def set_wide_conv_mode(mode: str) -> None:
    global _WIDE_MODE
    _WIDE_MODE = _check_mode("wide_conv", mode)


def set_fast_dw_mode(mode: str) -> None:
    global _DW_MODE
    _DW_MODE = _check_mode("fast_dw", mode)


def wide_conv_enabled() -> bool:
    return _WIDE_MODE == "on"  # "auto" is off, as in the JAX package


def fast_dw_enabled() -> bool:
    return _DW_MODE == "on"


def eligible(x_shape, w_shape, stride, padding, dilation=1,
             groups: int = 1) -> bool:
    """The kernels' shape rule: k3/s1/p1, no dilation or groups, Ci, Co >= 8.

    ``x_shape`` [N, Ci, D, H, W], ``w_shape`` [Co, Ci, 3, 3, 3]; stride,
    padding and dilation are ints or triples."""
    def triple(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)

    return (triple(stride) == (1, 1, 1) and triple(padding) == (1, 1, 1)
            and triple(dilation) == (1, 1, 1) and groups == 1
            and len(x_shape) == 5 and tuple(w_shape[2:]) == (3, 3, 3)
            and w_shape[1] == x_shape[1] and x_shape[1] >= 8
            and w_shape[0] >= 8)


def conv3d(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride=1, padding=0
           ) -> torch.Tensor:
    """3D convolution (torch nn.Conv3d semantics) through the route the
    modes select. ``w`` is already in x's dtype. On the kernel routes the
    bias is added after the conv, as gan3d_tpu/nn/layers.py:168-173 does;
    ``F.conv3d`` takes it in the conv."""
    on_wide, on_dw = wide_conv_enabled(), fast_dw_enabled()
    if (on_wide or on_dw) and eligible(x.shape, w.shape, stride, padding):
        from gan3d_tpu_torch.ops import cuda_conv

        fn = cuda_conv.WideConv3d if on_wide else cuda_conv.Conv3dK3Dw
        y = fn.apply(x, w)
        return y if bias is None else y + bias.reshape(1, -1, 1, 1, 1)
    return F.conv3d(x, w, bias, stride, padding)


def _x27_chunks(x: torch.Tensor, budget: int = CHUNK_BYTES
                ) -> Iterator[Tuple[int, int, int, torch.Tensor]]:
    """(sample, d0, d1, X27 [27*Ci, (d1-d0)*H*W] f32) over x [N,Ci,D,H,W],
    row tap*Ci + ci with tap = kd*9 + kh*3 + kw, zero outside the volume."""
    n, ci, d, h, w = x.shape
    dd = max(1, min(d, budget // (27 * ci * h * w * 4)))
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    for i in range(n):
        for d0 in range(0, d, dd):
            d1 = min(d, d0 + dd)
            slab = xp[i, :, d0:d1 + 2].float()
            views = [slab[:, kd:kd + d1 - d0, kh:kh + h, kw:kw + w]
                     .reshape(ci, -1)
                     for kd in range(3) for kh in range(3) for kw in range(3)]
            yield i, d0, d1, torch.cat(views, 0)


def conv3d_k3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """k3/s1/p1 conv as W2 @ X27 in f32; [N, Co, D, H, W] in x's dtype."""
    n, ci, d, h, wd = x.shape
    co = w.shape[0]
    w2 = w.float().reshape(co, ci, 27).transpose(1, 2).reshape(co, 27 * ci)
    out = torch.empty((n, co, d, h, wd), dtype=x.dtype, device=x.device)
    for i, d0, d1, x27 in _x27_chunks(x):
        out[i, :, d0:d1] = (w2 @ x27).reshape(co, d1 - d0, h, wd)
    return out


def conv3d_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW of a k3/s1/p1 conv from its input x [N,Ci,D,H,W] and output
    gradient g [N,Co,D,H,W]: f32 [Co, Ci, 3, 3, 3]."""
    ci, co = x.shape[1], g.shape[1]
    acc = torch.zeros((co, 27 * ci), dtype=torch.float32, device=x.device)
    for i, d0, d1, x27 in _x27_chunks(x):
        acc += g[i, :, d0:d1].reshape(co, -1).float() @ x27.T
    return acc.reshape(co, 27, ci).transpose(1, 2).reshape(co, ci, 3, 3, 3)


def _windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """[N, C, D, H, W] -> [N, C, D/k, k, H/k, k, W/k, k] (a view)."""
    n, c, d, h, w = x.shape
    return x.reshape(n, c, d // k, k, h // k, k, w // k, k)


def avg_pool3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """torch F.avg_pool3d with stride == window and no padding, as a
    reshape + mean (every dtype on every device; f32 accumulation)."""
    return _windows(x, window).mean(dim=(3, 5, 7))


def max_pool3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """torch F.max_pool3d with stride == window and no padding."""
    return _windows(x, window).amax(dim=(3, 5, 7))


def upsample_nearest3d(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample (torch F.interpolate's default mode)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def global_sum_pool(x: torch.Tensor) -> torch.Tensor:
    """Sum over D, H, W -> [N, C] (reference: biggan.py:118)."""
    return x.sum(dim=(2, 3, 4))

"""The W-Toeplitz direct k3/s1/p1 conv (K5) as an op with its VJP.

Counterpart of gan3d_tpu/ops/pallas_conv.py. The layout is the JAX op's:
x is [N, D, H, W, Cin] and w is [3, 3, 3, Cin, Cout] (DHWIO), so the JAX
package's weights need no conversion (``convert.py`` is not involved).

- ``toeplitz_weights`` / ``tile_input``: the plain functions of
  pallas_conv.py:49-74, with the 128-lane zero pad of ``_padded_lanes``
  (41-46): the Toeplitz weight B[3a+b][u*Cin+ci, t*Cout+co] =
  w[a, b, u-t, ci, co] and the overlapping W-tiles of the zero-padded input.
- ``pick_tile``: own copy of gan3d_tpu/ops/lane_conv.py:86-91.
- ``toeplitz_conv3d_plain``: the JAX algebra (``_kernel`` 105-112, ``_run``
  158-165): per (n, d) the 9 matmuls [H*nW, pad((T+2)Cin)] @
  [pad((T+2)Cin), T*Cout] in f32, then the unpack to [N, D, H, W, Cout].
- ``ToeplitzConv3d``: the custom VJP (168-189). Forward: the conv. dx: the
  same conv of the output gradient with ``flip(w, (0, 1, 2))`` and Cin/Cout
  swapped. dW: the backward-weights conv, which the JAX package leaves to
  XLA (177-185), here ``aten.convolution_backward`` on NCDHW views.
  First-order only, like the custom VJP.
- ``toeplitz_conv3d``: the op, counterpart of ``pallas_conv3d`` (152-155).
  It checks ``t >= 1`` and ``W % t == 0`` on every device. On a CPU tensor
  the conv is the plain version; on a CUDA tensor it is the hand-written
  kernel (``ops/cuda_conv.py:toeplitz_conv3d_cuda``,
  ``csrc/conv3d_toeplitz.cu``), which computes the same sum straight from
  x and w and raises on a dtype or shape it does not take. Nothing falls
  back.
- ``make_inputs``: the inputs of scripts/bench_lane_conv.py:62-64 from a
  numpy seed, on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from gan3d_tpu_torch.utils.platform import resolve_device

LANES = 128


def padded_lanes(t: int, c_in: int) -> int:
    """(T+2)*Cin rounded up to a multiple of 128 (pallas_conv.py:41-46)."""
    return -(-(t + 2) * c_in // LANES) * LANES


def pick_tile(c_out: int, width: int) -> Optional[int]:
    """Largest power-of-two T with T*c_out <= 128, T | width, T >= 2."""
    t = 1
    while 2 * t * c_out <= 128 and width % (2 * t) == 0 and 2 * t <= width:
        t *= 2
    return t if t >= 2 else None


def check_tile(x_shape, w_shape, t: int) -> None:
    """Raise ValueError unless x [N,D,H,W,Cin], w [3,3,3,Cin,Cout] and the
    tile t (t >= 1, W % t == 0) are what the op takes."""
    if len(x_shape) != 5 or tuple(w_shape[:3]) != (3, 3, 3) \
            or len(w_shape) != 5 or w_shape[3] != x_shape[4]:
        raise ValueError(f"toeplitz conv: want x [N,D,H,W,Cin] and w "
                         f"[3,3,3,Cin,Cout]; got {tuple(x_shape)}, "
                         f"{tuple(w_shape)}")
    if not isinstance(t, int) or t < 1 or x_shape[3] % t:
        raise ValueError(f"toeplitz conv: tile t={t!r} must be an int >= 1 "
                         f"dividing W={x_shape[3]}")


def toeplitz_weights(w: torch.Tensor, t: int) -> torch.Tensor:
    """[3,3,3,Cin,Cout] -> [9, pad((T+2)*Cin), T*Cout];
    B[3a+b][u*Cin+ci, tt*Cout+co] = w[a, b, u-tt, ci, co]."""
    c_in, c_out = w.shape[3], w.shape[4]
    w9 = w.reshape(9, 3, c_in, c_out)
    b = w.new_zeros((9, padded_lanes(t, c_in), t * c_out))
    for u in range(t + 2):
        for tt in range(t):
            if 0 <= u - tt <= 2:
                b[:, u * c_in:(u + 1) * c_in,
                  tt * c_out:(tt + 1) * c_out] = w9[:, u - tt]
    return b


def tile_input(x: torch.Tensor, t: int) -> torch.Tensor:
    """[N,D,H,W,Cin] -> overlapping W-tiles [N,D+2,H+2,nW,pad((T+2)*Cin)];
    tile j holds W positions jT-1 .. jT+T of the zero-padded input."""
    n, d, h, wd, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    # unfold puts the window last: [N, D+2, H+2, nW, Cin, T+2]
    xt = xp.unfold(3, t + 2, t).transpose(-1, -2)
    xt = xt.reshape(n, d + 2, h + 2, wd // t, (t + 2) * c)
    pad = padded_lanes(t, c) - (t + 2) * c
    return torch.nn.functional.pad(xt, (0, pad)) if pad else xt


def toeplitz_conv3d_plain(x: torch.Tensor, w: torch.Tensor, t: int
                          ) -> torch.Tensor:
    """The JAX kernel's algebra in f32, one sample at a time; [N,D,H,W,Cout]
    in x's dtype."""
    check_tile(x.shape, w.shape, t)
    n, d, h, wd, _ = x.shape
    c_out = w.shape[4]
    b = toeplitz_weights(w.float(), t)
    out = torch.empty((n, d, h, wd, c_out), dtype=x.dtype, device=x.device)
    for i in range(n):
        xt = tile_input(x[i:i + 1].float(), t)[0]   # [D+2, H+2, nW, lanes]
        acc = None
        for a in range(3):
            for bb in range(3):
                part = xt[a:a + d, bb:bb + h] @ b[a * 3 + bb]
                acc = part if acc is None else acc + part
        # [D, H, nW, T*Cout] -> [D, H, W, Cout] (contiguous unpack)
        out[i] = acc.reshape(d, h, wd, c_out)
    return out


def _conv(x: torch.Tensor, w: torch.Tensor, t: int) -> torch.Tensor:
    if x.is_cuda:
        from gan3d_tpu_torch.ops.cuda_conv import toeplitz_conv3d_cuda

        return toeplitz_conv3d_cuda(x, w)
    if x.device.type == "cpu":
        return toeplitz_conv3d_plain(x, w, t)
    raise ValueError(f"toeplitz conv: no implementation for device "
                     f"{x.device}")


def conv3d_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW [3,3,3,Cin,Cout] of a k3/s1/p1 conv from x [N,D,H,W,Cin] and the
    output gradient g [N,D,H,W,Cout], in x's dtype: the backward-weights
    conv the JAX package leaves to XLA (pallas_conv.py:177-185), on the
    NCDHW views of the channels-last tensors."""
    xc = x.permute(0, 4, 1, 2, 3)
    gc = g.to(x.dtype).permute(0, 4, 1, 2, 3)
    w_shape = (g.shape[4], x.shape[4], 3, 3, 3)
    one = [1, 1, 1]
    dw = torch.ops.aten.convolution_backward(
        gc, xc, xc.new_empty(w_shape), None, one, one, one, False,
        [0, 0, 0], 1, [False, True, False])[1]      # [Cout, Cin, 3, 3, 3]
    return dw.permute(2, 3, 4, 1, 0)


class ToeplitzConv3d(torch.autograd.Function):
    """k3/s1/p1 conv (DHWIO weights): the conv for the forward and dx, the
    backward-weights conv for dW. First-order only, like the custom VJP."""

    @staticmethod
    def forward(ctx, x, w, t):
        ctx.save_for_backward(x, w)
        ctx.t = t
        return _conv(x, w, t)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        g = g.contiguous()
        if ctx.needs_input_grad[0]:
            # conv of g with spatially flipped, in/out-swapped weights
            w_flip = w.flip(0, 1, 2).transpose(3, 4).contiguous()
            dx = _conv(g, w_flip.to(g.dtype), ctx.t).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3d_dw(x, g).to(w.dtype)
        return dx, dw, None


def toeplitz_conv3d(x: torch.Tensor, w: torch.Tensor, t: int
                    ) -> torch.Tensor:
    """k=3, stride 1, padding 1 direct conv; x [N,D,H,W,Cin], w
    [3,3,3,Cin,Cout], W % t == 0; [N,D,H,W,Cout] in x's dtype,
    differentiable once in x and w."""
    check_tile(x.shape, w.shape, t)
    return ToeplitzConv3d.apply(x, w, t)


def make_inputs(c: int, s: int, batch: int = 16,
                dtype: torch.dtype = torch.float32, seed: int = 0,
                platform: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """x [batch, s, s, s, c] ~ N(0, 1) and w [3,3,3,c,c] ~ N(0, 1/(27c)),
    the inputs of scripts/bench_lane_conv.py:62-64, drawn in f32 from
    ``numpy.random.default_rng(seed)``, in ``dtype``, on the card
    (``platform=""``, raising when there is none) or on the CPU
    (``platform="cpu"``)."""
    device = resolve_device(platform)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, s, s, s, c), np.float32)
    w = (rng.standard_normal((3, 3, 3, c, c)) / np.sqrt(27 * c)
         ).astype(np.float32)
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(w).to(device, dtype))

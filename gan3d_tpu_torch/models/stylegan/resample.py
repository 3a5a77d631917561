"""3D FIR resampling: upfirdn3d and conv3d_resample (NCDHW).

Counterpart of gan3d_tpu/models/stylegan/resample.py (reference
stylegan.py:126-294), with its quirks kept:

- ``setup_filter`` TILES the 2-D outer product of the 1-D taps along
  depth (the reference's ``repeat((1, 4, 1)).reshape(4, 4, 4)``) instead
  of taking a 3-D outer product: f3[i, j, k] = f[i] f[k] / (4 sum(f)^2);
- ``upfirdn3d`` zero-interleaves to n * up samples (trailing zeros), as
  the reference does, where an lhs-dilated conv makes (n - 1) * up + 1;
- the up path's FIR gain is ``up ** 2`` (the reference's 2-D heritage);
  the generator's skip-image upsample passes ``up ** 3`` itself;
- ``flip_weight=True`` is correlation (torch conv semantics); the up path
  is called with ``flip_weight=False``.

The filter is applied flipped (a true convolution), as the JAX package's
default ``flip_filter=False`` does; no caller of either package flips it.

Every op is a plain one: the zero-interleave by ``F.pad`` of a reshaped
view, pads and crops by ``F.pad`` (negative pads crop), the FIR as a
depthwise ``F.conv3d`` (groups = C), the up conv by ``F.conv_transpose3d``.
The JAX package's ``fast_fir`` / ``fast_c1`` lowerings (separable banded
matmuls for narrow channels) are TPU layout rewrites of these same ops
(ROADMAP A8): their config knobs are accepted and the plain op runs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def setup_filter_np(f1d: Sequence[float] = (1, 3, 3, 1)) -> np.ndarray:
    """The reference Conv3dLayer filter (stylegan.py:462-465), normalized
    to sum 1."""
    f = np.asarray(f1d, np.float32)
    f2 = f[None, :] * f[:, None]
    f3 = np.tile(f2, (1, len(f1d))).reshape(len(f1d), len(f1d), len(f1d))
    return f3 / f3.sum()


def setup_filter(f1d: Sequence[float] = (1, 3, 3, 1)) -> torch.Tensor:
    return torch.from_numpy(setup_filter_np(f1d))


def _pads(padding) -> List[int]:
    """[x0, x1, y0, y1, z0, z1] from an int or that list: x = W, y = H, z
    = D, the reference's order, which is also ``F.pad``'s for NCDHW."""
    if isinstance(padding, int):
        return [padding] * 6
    return [int(p) for p in padding]


def upfirdn3d(x: torch.Tensor, f: torch.Tensor, up: int = 1, down: int = 1,
              padding=0, gain: float = 1.0) -> torch.Tensor:
    """Upsample (zero-interleave), pad or crop, FIR, downsample; x is
    [N, C, D, H, W], f a [kd, kh, kw] filter."""
    n, c, d, h, w = x.shape
    if up > 1:
        x = x.reshape(n, c, d, 1, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1, 0, 0, 0, up - 1])
        x = x.reshape(n, c, d * up, h * up, w * up)
    x = F.pad(x, _pads(padding))
    f = torch.flip(f.to(x.device, torch.float32) * gain, (0, 1, 2))
    kern = f[None, None].repeat(c, 1, 1, 1, 1).to(x.dtype)
    return F.conv3d(x, kern, stride=down, groups=c)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding=0,
          groups: int = 1, flip_weight: bool = True) -> torch.Tensor:
    """Plain conv; flip_weight=True is correlation (torch conv semantics)."""
    if not flip_weight:
        w = torch.flip(w, (2, 3, 4))
    return F.conv3d(x, w.to(x.dtype), stride=stride, padding=padding,
                    groups=groups)


def conv3d_resample(x: torch.Tensor, w: torch.Tensor,
                    f: Optional[torch.Tensor] = None, up: int = 1,
                    down: int = 1, padding=0, groups: int = 1,
                    flip_weight: bool = True) -> torch.Tensor:
    """Conv with optional FIR up/downsampling (reference stylegan.py
    :202-294); w is [O, I / groups, kd, kh, kw]. The same case analysis
    and padding algebra as the JAX package's."""
    kd, kh, kw = w.shape[2:]
    if f is None:
        fw = fh = fd = 1
    else:
        fd, fh, fw = f.shape[2], f.shape[1], f.shape[0]
    px0, px1, py0, py1, pz0, pz1 = _pads(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
        pz0 += (fd + up - 1) // 2
        pz1 += (fd - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
        pz0 += (fd - down + 1) // 2
        pz1 += (fd - down) // 2
    pads = [px0, px1, py0, py1, pz0, pz1]

    # 1x1x1 kernel fast paths.
    if kw == kh == kd == 1 and down > 1 and up == 1:
        x = upfirdn3d(x, f, down=down, padding=pads)
        return _conv(x, w, groups=groups, flip_weight=flip_weight)
    if kw == kh == kd == 1 and up > 1 and down == 1:
        x = _conv(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn3d(x, f, up=up, padding=pads, gain=up ** 2)

    # Downsample only: FIR, then a strided conv.
    if down > 1 and up == 1:
        x = upfirdn3d(x, f, padding=pads)
        return _conv(x, w, stride=down, groups=groups,
                     flip_weight=flip_weight)

    # Upsample: a transposed conv (stride up, the JAX package's lhs-dilated
    # conv with the same taps), then the FIR.
    if up > 1:
        px0 -= kw - 1
        px1 -= kw - up
        py0 -= kh - 1
        py1 -= kh - up
        pz0 -= kd - 1
        pz1 -= kd - up
        pxt = max(min(-px0, -px1), 0)
        pyt = max(min(-py0, -py1), 0)
        pzt = max(min(-pz0, -pz1), 0)
        # conv_transpose3d correlates the dilated input with its weight
        # flipped and in/out swapped: flip_weight=False hands it w as is.
        wt = w if not flip_weight else torch.flip(w, (2, 3, 4))
        o, i = wt.shape[:2]
        wt = (wt.reshape(groups, o // groups, i, kd, kh, kw).transpose(1, 2)
              .reshape(groups * i, o // groups, kd, kh, kw))
        x = F.conv_transpose3d(x, wt.to(x.dtype), stride=up,
                               padding=(pzt, pyt, pxt), groups=groups)
        x = upfirdn3d(x, f, padding=[px0 + pxt, px1 + pxt, py0 + pyt,
                                     py1 + pyt, pz0 + pzt, pz1 + pzt],
                      gain=up ** 2)
        if down > 1:
            x = upfirdn3d(x, f, down=down)
        return x

    # Plain conv: symmetric non-negative pads go to the conv itself.
    if px0 == px1 and py0 == py1 and pz0 == pz1 \
            and px0 >= 0 and py0 >= 0 and pz0 >= 0:
        return _conv(x, w, padding=(pz0, py0, px0), groups=groups,
                     flip_weight=flip_weight)
    # Otherwise pad (or crop) first.
    return _conv(F.pad(x, pads), w, groups=groups, flip_weight=flip_weight)

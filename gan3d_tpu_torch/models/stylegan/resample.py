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

Under a space axis (parallel/sp.py) an input that is a depth slab (the
caller tells it at the layer's input and passes ``rp``; it is never told
from a padded or interleaved intermediate) takes its depth halo from the
neighbouring slabs (``sp.halo``; zeros at the volume's ends, which are
the op's own zero padding there) and is padded only on H and W; the
planes the halo adds are cropped from the output, which is this rank's
slab of the whole op's output. The halo follows from the padding
algebra: an upfirdn output o reads interleaved samples [down o - p0,
down o - p0 + k), so a slab of n planes needs ceil(p0 / up) planes
before it and floor((k - 1 - down - p0) / up) + 1 after (the
discriminator's skip FIR: 1 and 1; the generator's skip-image upsample:
1 and 1, then the interleave and a crop to 2n); the downsampling conv
(FIR, then a k3/s2 conv) reads 2 before and 2 after; the upsampling conv
(a transposed conv, then the FIR) 1 and 1.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from gan3d_tpu_torch.parallel import sp


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
              padding=0, gain: float = 1.0, rp=None) -> torch.Tensor:
    """Upsample (zero-interleave), pad or crop, FIR, downsample; x is
    [N, C, D, H, W], f a [kd, kh, kw] filter. With ``rp`` x is a depth
    slab and the output this rank's slab of the whole op's (whose depth
    must scale by up / down exactly)."""
    if rp is None:
        return _upfirdn3d(x, f, up, down, padding, gain)
    pads = _pads(padding)
    p0, k, n = pads[4], f.shape[0], x.shape[2]
    before = max(-(-p0 // up), 0)
    after = max((k - 1 - down - p0) // up + 1, 0)
    xh = sp.halo(x, before, after, rp)
    e = up * before - p0  # interleaved samples ahead of the first read
    length = up * (n + before + after) - e
    out = up * n // down
    return _upfirdn3d(xh, f, up, down,
                      pads[:4] + [-e, down * (out - 1) + k - length], gain)


def _upfirdn3d(x: torch.Tensor, f: torch.Tensor, up: int, down: int,
               padding, gain: float) -> torch.Tensor:
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
                    flip_weight: bool = True, rp=None) -> torch.Tensor:
    """Conv with optional FIR up/downsampling (reference stylegan.py
    :202-294); w is [O, I / groups, kd, kh, kw]. The same case analysis
    and padding algebra as the JAX package's. With ``rp`` x is a depth
    slab and the output this rank's slab of the whole conv's output."""
    slab = rp is not None
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
        x = upfirdn3d(x, f, down=down, padding=pads, rp=rp)
        return _conv(x, w, groups=groups, flip_weight=flip_weight)
    if kw == kh == kd == 1 and up > 1 and down == 1:
        x = _conv(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn3d(x, f, up=up, padding=pads, gain=up ** 2, rp=rp)

    # Downsample only: FIR, then a strided conv. On a slab: conv output o
    # reads FIR outputs [down o, down o + kd), FIR output m planes [m -
    # pz0, m - pz0 + fd): pz0 planes before the slab, kd + fd - 1 - down
    # - pz0 after, both convs then unpadded in depth.
    if down > 1 and up == 1:
        if slab:
            x = sp.halo(x, pz0, kd + fd - 1 - down - pz0, rp)
            pads[4:] = [0, 0]
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
        if slab:
            if down > 1:
                raise ValueError("no slab form for an up- and "
                                 "downsampling conv")
            # FIR output q reads transposed-conv outputs [q - pz0, q - pz0
            # + fd), which read inputs [ceil((o - kd + 1) / up), o // up]:
            # the halo, the transposed conv unpadded in depth, and its
            # outputs ahead of the slab's first read (e) and past its last
            # cropped by the FIR's depth pads
            n = x.shape[2]
            before = (pz0 + kd - 1) // up
            after = (fd - 2 - pz0) // up + 1
            x = sp.halo(x, before, after, rp)
            e = up * before - pz0
            length = (n + before + after - 1) * up + kd
            zpads = [-e, up * n - 1 + fd - length + e]
            pzt = 0
        else:
            zpads = [pz0 + pzt, pz1 + pzt]
        # conv_transpose3d correlates the dilated input with its weight
        # flipped and in/out swapped: flip_weight=False hands it w as is.
        wt = w if not flip_weight else torch.flip(w, (2, 3, 4))
        o, i = wt.shape[:2]
        wt = (wt.reshape(groups, o // groups, i, kd, kh, kw).transpose(1, 2)
              .reshape(groups * i, o // groups, kd, kh, kw))
        x = F.conv_transpose3d(x, wt.to(x.dtype), stride=up,
                               padding=(pzt, pyt, pxt), groups=groups)
        x = upfirdn3d(x, f, padding=[px0 + pxt, px1 + pxt, py0 + pyt,
                                     py1 + pyt] + zpads,
                      gain=up ** 2)
        if down > 1:
            x = upfirdn3d(x, f, down=down)
        return x

    # Plain conv: symmetric non-negative pads go to the conv itself. On a
    # slab the depth pads are the halo (the output keeps the depth).
    if slab:
        if pz0 < 0 or pz1 < 0 or pz0 + pz1 != kd - 1:
            raise ValueError(f"no slab form for a conv with depth pads "
                             f"{pz0}, {pz1} and kernel {kd}")
        x = sp.halo(x, pz0, pz1, rp)
        pz0 = pz1 = 0
    if px0 == px1 and py0 == py1 and pz0 == pz1 \
            and px0 >= 0 and py0 >= 0 and pz0 >= 0:
        return _conv(x, w, padding=(pz0, py0, px0), groups=groups,
                     flip_weight=flip_weight)
    # Otherwise pad (or crop) first.
    return _conv(F.pad(x, [px0, px1, py0, py1, pz0, pz1]), w, groups=groups,
                 flip_weight=flip_weight)

"""StyleGAN2-3D discriminator (NCDHW).

Counterpart of gan3d_tpu/models/stylegan/discriminator.py (reference
stylegan.py:721-928): resnet blocks ``b{res}`` from the resolution down to
8^3 with the channel table of ``synthesis_channels(cfg.filterD)``; fromrgb
(1x1, lrelu) on the first block only; conv0 (3^3), conv1 (3^3, down 2
through the FIR) with gain sqrt(0.5), plus a biasless 1x1 skip (down 2)
with gain sqrt(0.5). Then the epilogue ``b4``, in f32: minibatch-std
(group 4) -> 3^3 conv -> FC over the flattened 4^3 volume -> FC -> one
logit. The blocks run in cfg.compute_dtype; the logits are f32. The
epilogue flattens NCDHW as the reference does (the JAX package flattens
NDHWC and its exporter permutes that FC's weight to this order).

``MinibatchStdLayer`` computes what the JAX package computes, which
differs from the reference: see its docstring. ``cfg.remat`` makes each
block a group recomputed in backward (nn/remat.py;
gan3d_tpu/models/stylegan/discriminator.py:139); StyleGAN-1 uses this D.

Under a space axis (parallel/sp.py) the blocks run on this rank's depth
slabs (layers.py; a block whose output side runs whole gathers it), the
minibatch-std statistics sum over space, and the epilogue gathers its 4^3
input where it is a slab (S = 2): its FC flattens NCDHW, so a rank's
columns are not contiguous, and the gathered whole is exact. The logits
are whole and alike on every rank of a space group.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models.biggan import compute_dtype
from gan3d_tpu_torch.models.stylegan.generator import synthesis_channels
from gan3d_tpu_torch.models.stylegan.layers import (Conv3dLayer,
                                                    FullyConnectedLayer)
from gan3d_tpu_torch.nn import remat
from gan3d_tpu_torch.parallel import sp

SQRT_HALF = float(np.sqrt(0.5))


class DiscriminatorBlock(nn.Module):
    """``in_channels`` 0 marks the first block: its input is the image,
    which fromrgb takes from one channel to ``tmp_channels``, the width of
    every later block's input."""

    def __init__(self, in_channels: int, tmp_channels: int,
                 out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels, self.dtype = in_channels, dtype
        if in_channels == 0:
            self.fromrgb = Conv3dLayer(1, tmp_channels, 1, activation="lrelu")
        self.skip = Conv3dLayer(tmp_channels, out_channels, 1, bias=False,
                                down=2)
        self.conv0 = Conv3dLayer(tmp_channels, tmp_channels, 3,
                                 activation="lrelu")
        self.conv1 = Conv3dLayer(tmp_channels, out_channels, 3,
                                 activation="lrelu", down=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.in_channels == 0:
            x = self.fromrgb(x.to(self.dtype))
        y = self.skip(x, gain=SQRT_HALF)
        x = self.conv0(x)
        x = self.conv1(x, gain=SQRT_HALF)
        return y + x


class MinibatchStdLayer(nn.Module):
    """Per-group feature stddev appended as extra channels, as the JAX
    package computes it (gan3d_tpu/models/stylegan/discriminator.py:88-93).

    The batch is split as [group_size, n // group_size]: sample s joins
    group s % (n // g), but the groups' statistics are then spread with
    ``repeat``, so sample s gets the statistic of group s // g. The
    reference's torch layer (stylegan.py:814-835) tiles them instead
    (``y.repeat(G, 1, D, H, W)``), so there each sample gets its own
    group's. This layer keeps the JAX package's assignment (ROADMAP C).

    The groups span the global batch: in a data-parallel run (``replicas``)
    every rank's rows are gathered (differentiably: the backward sums the
    gradient over ranks), the statistics computed on the whole, and each
    rank keeps its rows of the result. On a depth slab the rows are
    gathered over the data group alone and the mean over (C, D, H, W)
    sums the slabs' parts over the space group (``sp.allsum``: a whole
    statistic that meets this rank's slab).
    """

    def __init__(self, group_size: int = 4, num_channels: int = 1):
        super().__init__()
        self.group_size, self.num_channels = group_size, num_channels
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rp = self.replicas
        xs = x if rp is None else rp.all_gather(x)
        n, c, d, h, w = xs.shape
        g = min(self.group_size, n)
        f = self.num_channels
        y = xs.float().reshape(g, n // g, f, c // f, d, h, w)
        y = y - y.mean(dim=0, keepdim=True)
        y = torch.sqrt((y * y).mean(dim=0) + 1e-8)
        if sp.on(rp) and sp.is_sharded(x):
            cnt = y[0, 0].numel() * rp.space
            y = sp.allsum(y.sum(dim=(2, 3, 4, 5)), rp) / cnt
        else:
            y = y.mean(dim=(2, 3, 4, 5))                # [n // g, F]
        y = y.repeat_interleave(g, dim=0)               # [n, F]
        if rp is not None:
            y = rp.rows(y)
        y = y.reshape(x.shape[0], f, 1, 1, 1)
        y = y.expand(x.shape[0], f, d, h, w).to(x.dtype)
        return torch.cat([x, y], dim=1)


class DiscriminatorEpilogue(nn.Module):
    """At 4^3, in f32: minibatch-std (groups of 4, one channel), conv, FC,
    FC to one logit."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.mbstd = MinibatchStdLayer(4, 1)
        self.conv = Conv3dLayer(in_channels + 1, in_channels, 3,
                                activation="lrelu")
        self.fc = FullyConnectedLayer(in_channels * 4 ** 3, in_channels,
                                      activation="lrelu")
        self.out = FullyConnectedLayer(in_channels, 1)
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mbstd(x.float())
        if sp.on(self.replicas) and sp.is_sharded(x):
            x = sp.gather(x, self.replicas)
        x = self.conv(x)
        return self.out(self.fc(x.reshape(x.shape[0], -1)))


class Discriminator(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        dtype = compute_dtype(cfg)
        self.remat = cfg.remat
        res = cfg.resolution
        chans = synthesis_channels(cfg.filterD, res)
        self.block_resolutions = [2 ** i
                                  for i in range(int(np.log2(res)), 2, -1)]
        for r in self.block_resolutions:
            setattr(self, f"b{r}", DiscriminatorBlock(
                chans[r] if r < res else 0, chans[r], chans[r // 2],
                dtype=dtype))
        self.b4 = DiscriminatorEpilogue(chans[4])

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img
        for r in self.block_resolutions:
            x = remat.sequential([getattr(self, f"b{r}")], x, self.remat)
        return self.b4(x)

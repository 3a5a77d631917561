"""BigGAN-deep residual blocks (NCDHW).

Counterparts of gan3d_tpu/nn/blocks.py:33-123 (reference utils.py:47-132),
in their plain composed form. Faithful quirks:
- the GBlockDeep shortcut keeps only the first ``out_channels`` channels
  when the block shrinks (blocks.py:58-59);
- the DBlockDeep shortcut concatenates a 1x1 conv of the (pooled) input
  for the extra channels (blocks.py:108-122);
- DBlockDeep is always spectrally normalized (blocks.py:88); GBlockDeep
  follows the ``plain`` (sngan) flag.

Under a model axis (parallel/tp.py) the shortcut meets conv4's output in
its form: the G shortcut's channel slice and D's concatenation take the
whole input (gathered), then the slice of conv4's rank. Under a space axis
(parallel/sp.py) both run on depth slabs as they are (the G shortcut's
channel slice and D's concatenation are per voxel; the 2-windows of the
upsample and the pool align with a slab's even start), and each resampled
tensor takes the form its new side has (``sp.form``: the 4^3 grid at S =
4 is gathered after D's pool, split after G's upsample).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan3d_tpu_torch.nn.layers import SNConv3d
from gan3d_tpu_torch.nn.norm import BatchNorm3d
from gan3d_tpu_torch.ops.conv3d import avg_pool3d, upsample_nearest3d
from gan3d_tpu_torch.parallel import sp, tp


def _conv4_local(block: nn.Module) -> bool:
    """Whether conv4 writes its rank's slice of the output channels."""
    return (getattr(block.conv4, "tp_span", None) is not None
            and not block.conv4.tp_gather_out)


class GBlockDeep(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 upsample: bool = False, plain: bool = False,
                 channel_ratio: int = 4):
        super().__init__()
        hid = in_channels // channel_ratio
        self.in_channels, self.out_channels = in_channels, out_channels
        self.upsample = upsample
        self.bn1 = BatchNorm3d(in_channels)
        self.conv1 = SNConv3d(in_channels, hid, 1, padding=0, plain=plain)
        self.bn2 = BatchNorm3d(hid)
        self.conv2 = SNConv3d(hid, hid, 3, padding=1, plain=plain)
        self.bn3 = BatchNorm3d(hid)
        self.conv3 = SNConv3d(hid, hid, 3, padding=1, plain=plain)
        self.bn4 = BatchNorm3d(hid)
        self.conv4 = SNConv3d(hid, out_channels, 1, padding=0, plain=plain)
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def _shortcut(self, x: torch.Tensor) -> torch.Tensor:
        """x[:, :out_channels] in conv4's output form."""
        rp, cin, out = self.replicas, self.in_channels, self.out_channels
        if not tp.on(rp):
            return x[:, :out]
        local = _conv4_local(self)
        if cin == out:
            return tp.layout(x, out, local, rp)
        return tp.layout(tp.layout(x, cin, False, rp)[:, :out], out, local,
                         rp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.bn1(x)))
        h = F.relu(self.bn2(h))
        x = self._shortcut(x)
        if self.upsample:
            x = sp.form(upsample_nearest3d(x, 2), self.replicas)
            h = sp.form(upsample_nearest3d(h, 2), self.replicas)
        h = F.relu(self.bn3(self.conv2(h)))
        h = F.relu(self.bn4(self.conv3(h)))
        return self.conv4(h) + x


class DBlockDeep(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 downsample: bool = False, channel_ratio: int = 4):
        super().__init__()
        hid = out_channels // channel_ratio
        self.downsample = downsample
        self.conv1 = SNConv3d(in_channels, hid, 1, padding=0)
        self.conv2 = SNConv3d(hid, hid, 3, padding=1)
        self.conv3 = SNConv3d(hid, hid, 3, padding=1)
        self.conv4 = SNConv3d(hid, out_channels, 1, padding=0)
        self.conv_sc = (SNConv3d(in_channels, out_channels - in_channels, 1,
                                 padding=0)
                        if in_channels != out_channels else None)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # every caller pre-activates (gan3d_tpu/nn/blocks.py:80, 90)
        h = self.conv1(F.relu(x))
        h = self.conv2(F.relu(h))
        h = self.conv3(F.relu(h))
        h = F.relu(h)
        sc = x
        if self.downsample:
            h = sp.form(avg_pool3d(h, 2), self.replicas)
            sc = sp.form(avg_pool3d(sc, 2), self.replicas)
        h = self.conv4(h)
        rp = self.replicas
        if not tp.on(rp):
            if self.conv_sc is not None:
                sc = torch.cat([sc, self.conv_sc(sc)], dim=1)
            return h + sc
        cin, out = self.in_channels, self.out_channels
        if self.conv_sc is not None:
            sc = torch.cat([tp.layout(sc, cin, False, rp),
                            tp.layout(self.conv_sc(sc), out - cin, False,
                                      rp)], dim=1)
        return h + tp.layout(sc, out, _conv4_local(self), rp)

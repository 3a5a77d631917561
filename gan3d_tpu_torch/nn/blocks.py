"""BigGAN-deep residual blocks (NCDHW).

Counterparts of gan3d_tpu/nn/blocks.py:33-123 (reference utils.py:47-132),
in their plain composed form. Faithful quirks:
- the GBlockDeep shortcut keeps only the first ``out_channels`` channels
  when the block shrinks (blocks.py:58-59);
- the DBlockDeep shortcut concatenates a 1x1 conv of the (pooled) input
  for the extra channels (blocks.py:108-122);
- DBlockDeep is always spectrally normalized (blocks.py:88); GBlockDeep
  follows the ``plain`` (sngan) flag.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan3d_tpu_torch.nn.layers import SNConv3d
from gan3d_tpu_torch.nn.norm import BatchNorm3d
from gan3d_tpu_torch.ops.conv3d import avg_pool3d, upsample_nearest3d


class GBlockDeep(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 upsample: bool = False, plain: bool = False,
                 channel_ratio: int = 4):
        super().__init__()
        hid = in_channels // channel_ratio
        self.out_channels = out_channels
        self.upsample = upsample
        self.bn1 = BatchNorm3d(in_channels)
        self.conv1 = SNConv3d(in_channels, hid, 1, padding=0, plain=plain)
        self.bn2 = BatchNorm3d(hid)
        self.conv2 = SNConv3d(hid, hid, 3, padding=1, plain=plain)
        self.bn3 = BatchNorm3d(hid)
        self.conv3 = SNConv3d(hid, hid, 3, padding=1, plain=plain)
        self.bn4 = BatchNorm3d(hid)
        self.conv4 = SNConv3d(hid, out_channels, 1, padding=0, plain=plain)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.bn1(x)))
        h = F.relu(self.bn2(h))
        x = x[:, :self.out_channels]
        if self.upsample:
            x = upsample_nearest3d(x, 2)
            h = upsample_nearest3d(h, 2)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # every caller pre-activates (gan3d_tpu/nn/blocks.py:80, 90)
        h = self.conv1(F.relu(x))
        h = self.conv2(F.relu(h))
        h = self.conv3(F.relu(h))
        h = F.relu(h)
        sc = x
        if self.downsample:
            h = avg_pool3d(h, 2)
            sc = avg_pool3d(sc, 2)
        h = self.conv4(h)
        if self.conv_sc is not None:
            sc = torch.cat([sc, self.conv_sc(sc)], dim=1)
        return h + sc

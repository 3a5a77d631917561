"""Pooling and resampling helpers of the BigGAN path (NCDHW).

Counterparts of gan3d_tpu/ops/conv3d.py:134-190. The convolution itself is
``F.conv3d`` in the layers; the JAX package's TPU rewrites of it
(conv3d.py:57-84) have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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

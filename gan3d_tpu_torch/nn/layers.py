"""Conv / Linear layers with optional spectral normalization (NCDHW).

Counterparts of gan3d_tpu/nn/layers.py. Spectral norm is
``torch.nn.utils.parametrizations.spectral_norm``, which has the semantics
the JAX package copies from it (layers.py:1-22):

- the weight is viewed as a matrix [out, in*kd*kh*kw];
- one power-method step ``u <- normalize(W v); v <- normalize(W^T u)`` per
  forward in train mode, stored in the ``_u`` / ``_v`` buffers — this
  includes forwards under ``torch.no_grad()`` and forwards of a network
  whose parameters are not being updated;
- ``sigma = u . (W v)`` with the gradient flowing through W only;
- 15 warm-start power steps at construction;
- state_dict keys ``parametrizations.weight.original`` / ``.0._u`` /
  ``.0._v``, the reference's layout (gan3d_tpu/eval/export.py:59-84).

Each forward reads ``self.weight`` exactly once, so the power method steps
once per forward. Parameters stay f32; the weight is cast to the input's
dtype at the conv (the compute-dtype policy, gan3d_tpu/config.py:82).

``plain=True`` skips spectral norm: the reference's inverted ``sngan=True``
flag (utils.py:9-11).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils.parametrizations import spectral_norm


class Conv3d(nn.Conv3d):
    """nn.Conv3d whose weight and bias are cast to the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 bias: bool = True, orthogonal: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias)
        if orthogonal:
            nn.init.orthogonal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv3d(x, w, b, self.stride, self.padding, self.dilation,
                        self.groups)


class Linear(nn.Linear):
    """nn.Linear whose weight and bias are cast to the input's dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 orthogonal: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        if orthogonal:
            nn.init.orthogonal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, w, b)


class SNConv3d(Conv3d):
    """Spectrally-normalized 3D conv (reference: utils.py snconv3d)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 bias: bool = True, plain: bool = False,
                 orthogonal: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias, orthogonal=orthogonal)
        if not plain:
            spectral_norm(self)


class SNLinear(Linear):
    """Spectrally-normalized dense layer (reference: utils.py snlinear)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 plain: bool = False, orthogonal: bool = False):
        super().__init__(in_features, out_features, bias=bias,
                         orthogonal=orthogonal)
        if not plain:
            spectral_norm(self)

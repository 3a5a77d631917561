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
Convs go through ``ops/conv3d.conv3d``, which picks the route the
``wide_conv`` / ``fast_dw`` modes select; the gradient reaches the
original weight through the route's weight input.

Under a model axis (``replicas`` with ``model`` > 1, parallel/tp.py) a
layer whose weight the rule shards holds its output channels' slice and
computes only those (``tp.run``: its input gathered when it arrives
sharded, its input gradient summed over the model group); a replicated
layer computes alike on every rank. Under a space axis (``replicas`` with
``space`` > 1, parallel/sp.py) a conv on a depth slab takes its depth halo
from the neighbouring slabs (``sp.conv3d``, ``sp.conv_transpose3d``); the
weights stay whole.

``plain=True`` skips spectral norm: the reference's inverted ``sngan=True``
flag (utils.py:9-11). ``std`` draws the weight from N(0, std) before the
spectral norm's warm start (the DCGAN's init, gan3d_tpu/models/dcgan.py:61).

``ConvTranspose3d`` (gan3d_tpu/nn/layers.py:177-209, ops/conv3d.py:97-133)
is torch's, with its weight [Cin, Cout, kd, kh, kw] and bias cast to the
input's dtype; the JAX kernel [kd, kh, kw, Cin, Cout] maps to it by the
transpose (3, 4, 0, 1, 2) and no flip (the JAX op flips internally to
reproduce these semantics). The JAX ``fast_pix`` rewrite of it is exact
algebra (ROADMAP A8): the port runs the plain op.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils.parametrizations import spectral_norm

from gan3d_tpu_torch.ops.conv3d import conv3d
from gan3d_tpu_torch.parallel import sp, tp


def _cast(b: Optional[torch.Tensor], x: torch.Tensor
          ) -> Optional[torch.Tensor]:
    return None if b is None else b.to(x.dtype)


class Conv3d(nn.Conv3d):
    """nn.Conv3d whose weight and bias are cast to the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 bias: bool = True, orthogonal: bool = False,
                 std: Optional[float] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias)
        if orthogonal:
            nn.init.orthogonal_(self.weight)
        if std is not None:
            nn.init.normal_(self.weight, 0.0, std)
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def _op(self, x: torch.Tensor, b: Optional[torch.Tensor]
            ) -> torch.Tensor:
        return conv3d(x, self.weight.to(x.dtype), _cast(b, x), self.stride,
                      self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if sp.on(self.replicas):
            return sp.conv3d(self, x)
        if tp.on(self.replicas):
            return tp.run(self, x, self._op)
        return self._op(x, self.bias)


class ConvTranspose3d(nn.ConvTranspose3d):
    """nn.ConvTranspose3d whose weight and bias are cast to the input's
    dtype; ``std`` draws the weight from N(0, std)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 4, stride: int = 2, padding: int = 1,
                 bias: bool = True, std: Optional[float] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias)
        if std is not None:
            nn.init.normal_(self.weight, 0.0, std)
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def _op(self, x: torch.Tensor, b: Optional[torch.Tensor]
            ) -> torch.Tensor:
        return F.conv_transpose3d(x, self.weight.to(x.dtype), _cast(b, x),
                                  self.stride, self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if sp.on(self.replicas):
            return sp.conv_transpose3d(self, x)
        if tp.on(self.replicas):
            return tp.run(self, x, self._op)
        return self._op(x, self.bias)


class Linear(nn.Linear):
    """nn.Linear whose weight and bias are cast to the input's dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 orthogonal: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        if orthogonal:
            nn.init.orthogonal_(self.weight)
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def _op(self, x: torch.Tensor, b: Optional[torch.Tensor]
            ) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(b, x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tp.on(self.replicas):
            return tp.run(self, x, self._op)
        return self._op(x, self.bias)


class SNConv3d(Conv3d):
    """Spectrally-normalized 3D conv (reference: utils.py snconv3d)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 bias: bool = True, plain: bool = False,
                 orthogonal: bool = False, std: Optional[float] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias, orthogonal=orthogonal, std=std)
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

"""SAGAN-style 3D self-attention with max-pooled keys/values (NCDHW).

Counterpart of gan3d_tpu/nn/attention.py (reference utils.py:22-45): 1x1x1
spectrally-normalized convs f/g/h to ch//8 with no bias, g and h max-pooled
2x so the key length is DHW/8, unscaled softmax(f g^T), output conv v back
to ch, and a learned scalar gamma initialized to 0 (so a fresh block is the
identity). Voxels are flattened in (d, h, w) order, as in the JAX module.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gan3d_tpu_torch.nn.layers import SNConv3d
from gan3d_tpu_torch.ops.attention import pooled_attention
from gan3d_tpu_torch.ops.conv3d import max_pool3d


class SelfAttention3d(nn.Module):
    """Always spectrally normalized (the reference's Attention never passes
    the sngan flag: utils.py:29-32)."""

    def __init__(self, ch: int):
        super().__init__()
        c = ch // 8
        self.f = SNConv3d(ch, c, 1, padding=0, bias=False)
        self.g = SNConv3d(ch, c, 1, padding=0, bias=False)
        self.h = SNConv3d(ch, c, 1, padding=0, bias=False)
        self.v = SNConv3d(c, ch, 1, padding=0, bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, d, h, w = x.shape

        def tokens(t: torch.Tensor) -> torch.Tensor:  # [N,c,...] -> [N,T,c]
            return t.reshape(n, t.shape[1], -1).transpose(1, 2)

        q = tokens(self.f(x))
        k = tokens(max_pool3d(self.g(x), 2))
        v = tokens(max_pool3d(self.h(x), 2))
        o = pooled_attention(q, k, v).to(q.dtype)          # [N, L, c]
        o = o.transpose(1, 2).reshape(n, -1, d, h, w)
        return self.gamma.to(x.dtype) * self.v(o) + x

"""SAGAN-style 3D self-attention with max-pooled keys/values (NCDHW).

Counterpart of gan3d_tpu/nn/attention.py (reference utils.py:22-45): 1x1x1
spectrally-normalized convs f/g/h to ch//8 with no bias, g and h max-pooled
2x so the key length is DHW/8, unscaled softmax(f g^T), output conv v back
to ch, and a learned scalar gamma initialized to 0 (so a fresh block is the
identity). Voxels are flattened in (d, h, w) order, as in the JAX module.

Under a model axis (parallel/tp.py) the block takes its input whole
(gathered, and saved as this rank's slice), gathers q, k and v where a
sharded projection wrote a slice, runs the kernels on every rank, and
gives its output in its input's form. ``tp_replicated`` (True) keeps its
parameters whole; the DCGAN family clears it (parallel/tp.py).

Under a space axis (parallel/sp.py) a block on a depth slab takes this
rank's queries: L/S tokens, contiguous in (d, h, w) order since depth is
outermost. g and h are max-pooled on the slab (an even number of planes)
and gathered over space in depth order, the whole M = L/8 keys of one
process, whose gradients (dk, dv over the local queries) the gather's
backward sums over space. The kernels take [N, L/S, c] against [N, M,
c]; v's projection and gamma act on the slab.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from gan3d_tpu_torch.nn.layers import SNConv3d
from gan3d_tpu_torch.ops.attention import pooled_attention
from gan3d_tpu_torch.ops.conv3d import max_pool3d
from gan3d_tpu_torch.parallel import sp, tp


class SelfAttention3d(nn.Module):
    """Always spectrally normalized (the reference's Attention never passes
    the sngan flag: utils.py:29-32)."""

    def __init__(self, ch: int):
        super().__init__()
        c = self.c = ch // 8
        self.f = SNConv3d(ch, c, 1, padding=0, bias=False)
        self.g = SNConv3d(ch, c, 1, padding=0, bias=False)
        self.h = SNConv3d(ch, c, 1, padding=0, bias=False)
        self.v = SNConv3d(c, ch, 1, padding=0, bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))
        self.ch = ch
        self.tp_replicated = True
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rp = self.replicas
        if sp.on(rp) and sp.is_sharded(x):
            sp.mark(self.gamma)  # the projections mark themselves
            return self._branch(x, space=rp) + x
        if not tp.on(rp):
            return self._branch(x) + x
        local = tp.is_local(x, self.ch)
        full = tp.gather(x, rp) if local else x
        with (tp.regathered(full, x, rp) if local
              else contextlib.nullcontext()):
            y = self._branch(full, rp)
        return tp.layout(y, self.ch, local, rp) + x

    def _branch(self, x: torch.Tensor, rp=None, space=None
                ) -> torch.Tensor:
        """gamma * v(attention) of the whole input ``x``, or of its depth
        slab under the space axis ``space``; under a model axis q, k, v
        and v's output are gathered where a sharded projection wrote a
        slice (gamma then meets every channel, as its gradient needs)."""
        n, _, d, h, w = x.shape

        def tokens(t: torch.Tensor) -> torch.Tensor:  # [N,c,...] -> [N,T,c]
            if rp is not None:
                t = tp.layout(t, self.c, False, rp)
            return t.reshape(n, t.shape[1], -1).transpose(1, 2)

        def pooled(t: torch.Tensor) -> torch.Tensor:
            t = max_pool3d(t, 2)
            return t if space is None else sp.gather_summed(t, space)

        q = tokens(self.f(x))
        k = tokens(pooled(self.g(x)))
        v = tokens(pooled(self.h(x)))
        o = pooled_attention(q, k, v).to(q.dtype)          # [N, L, c]
        o = o.transpose(1, 2).reshape(n, -1, d, h, w)
        y = self.v(o)
        if rp is not None:
            y = tp.layout(y, self.ch, False, rp)
        return self.gamma.to(x.dtype) * y

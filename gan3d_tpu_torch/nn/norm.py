"""Normalization layers (counterparts of gan3d_tpu/nn/norm.py).

- BatchNorm3d (norm.py:93-118): torch's own BatchNorm3d has the semantics
  the JAX package copies from it: statistics over the whole batch (the JAX
  ``num_groups=1`` path), biased variance for the normalization, unbiased
  variance for the running-stat update, momentum 0.1, eps 1e-5. Parameters
  and running stats are f32; a bf16 input is normalized with f32
  statistics (CUDA's batch norm accumulates in f32) and comes back in
  bf16. ``std`` draws the scale from N(1, std) (the DCGAN's init,
  gan3d_tpu/models/dcgan.py:39-40). The grouped and cross-replica scopes
  (norm.py:73-92) are not ported.
- LayerNormVolume (norm.py:121-144): torch's LayerNorm over [C, D, H, W]
  of an NCDHW input, per sample, eps 1e-5, with a full-shape affine
  [C, D, H, W] (the JAX scale and bias are (D, H, W, C): the transpose
  (3, 0, 1, 2) maps them, as gan3d_tpu/eval/export.py:_layernorm_out
  does). Statistics in at least f32 (``_stat_dtype``, norm.py:31-34); the
  output in the input's dtype. The WGAN DCGAN discriminator's norm.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm3d(nn.BatchNorm3d):
    def __init__(self, num_features: int, std: Optional[float] = None):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        if std is not None:
            nn.init.normal_(self.weight, 1.0, std)


class LayerNormVolume(nn.LayerNorm):
    def __init__(self, shape: Sequence[int]):
        super().__init__(tuple(shape), eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sdt = torch.promote_types(x.dtype, torch.float32)
        return F.layer_norm(x.to(sdt), self.normalized_shape,
                            self.weight.to(sdt), self.bias.to(sdt),
                            self.eps).to(x.dtype)

"""StyleGAN2 mapping network (counterpart of
gan3d_tpu/models/stylegan/mapping.py; reference stylegan.py:329-392).

z -> 2nd-moment normalization -> 8 FC layers (lrelu, lr_multiplier 0.01)
-> w, broadcast to ``num_ws`` copies, all in f32. The ``w_avg`` buffer is
never updated: the reference's forward defaults skip_w_avg_update=True and
no call site unsets it (the JAX package's mapping.py:54-58), so training
leaves it at its initial zeros. Truncation pulls w towards ``w_avg`` by
``truncation_psi``, for the first ``truncation_cutoff`` ws if given.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from gan3d_tpu_torch.models.stylegan.layers import (FullyConnectedLayer,
                                                    normalize_2nd_moment)

NUM_LAYERS = 8
LR_MULTIPLIER = 0.01


class MappingNetwork(nn.Module):
    def __init__(self, z_dim: int = 512, w_dim: int = 512,
                 num_ws: int = 1):
        super().__init__()
        self.num_ws = num_ws
        for idx in range(NUM_LAYERS):
            setattr(self, f"fc{idx}", FullyConnectedLayer(
                z_dim if idx == 0 else w_dim, w_dim, activation="lrelu",
                lr_multiplier=LR_MULTIPLIER))
        self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, z: torch.Tensor, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None) -> torch.Tensor:
        x = normalize_2nd_moment(z.reshape(z.shape[0], -1).float())
        for idx in range(NUM_LAYERS):
            x = getattr(self, f"fc{idx}")(x)
        x = x[:, None, :].repeat(1, self.num_ws, 1)
        if truncation_psi != 1.0:
            wa = self.w_avg
            truncated = wa + truncation_psi * (x - wa)
            if truncation_cutoff is None:
                x = truncated
            else:
                idx = torch.arange(self.num_ws, device=x.device)[None, :,
                                                                 None]
                x = torch.where(idx < truncation_cutoff, truncated, x)
        return x

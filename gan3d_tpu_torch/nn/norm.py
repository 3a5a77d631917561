"""BatchNorm3d (counterpart of gan3d_tpu/nn/norm.py:93-118).

torch's own BatchNorm3d has the semantics the JAX package copies from it:
statistics over the whole batch (the JAX ``num_groups=1`` path), biased
variance for the normalization, unbiased variance for the running-stat
update, momentum 0.1, eps 1e-5. Parameters and running stats are f32; a
bf16 input is normalized with f32 statistics (CUDA's batch norm accumulates
in f32) and comes back in bf16. The grouped and cross-replica scopes
(norm.py:73-92) are not ported.
"""

from __future__ import annotations

import torch.nn as nn


class BatchNorm3d(nn.BatchNorm3d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

"""RandomCrop3D, the msl DCGAN discriminator's front end (NCDHW).

Counterpart of gan3d_tpu/nn/msl.py:26-53 (the reference imports
``msl.RandomCrop3D`` but ships no msl.py; the JAX package reconstructs it
from its call site, dcgan.py:96-116): a one-channel volume [N, 1, D, H, W]
maps to [N, n_crops, D/2, H/2, W/2], n_crops random half-size crops of the
volume stacked as channels, with offsets uniform in [0, D - D/2] (and so on
for H and W), drawn anew in every forward.

The forward takes its offsets, [N, n_crops, 3] (long; d, h, w):
``draw_offsets`` draws them from an explicit ``torch.Generator`` (the
train step passes its seeded one), and tests and the card's checks fix
them. All crops are one gather over index arithmetic, not n_crops slices
a sample; its backward is one scatter-add into the volume.

Under a space axis (parallel/sp.py) the one-channel input arrives as
depth slabs: the crop gathers it whole (16 MB at 64^3 and batch 16 in
f32), crops at the global offsets (drawn alike on every rank of a space
group) and keeps this rank's depth slab of the crop volume; the input's
gradient, partial on each rank, is summed over space by the gather's
backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from gan3d_tpu_torch.parallel import sp


class RandomCrop3D(nn.Module):
    def __init__(self, n_crops: int = 128):
        super().__init__()
        self.n_crops = n_crops
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def draw_offsets(self, shape, generator: Optional[torch.Generator],
                     device=None) -> torch.Tensor:
        """[N, n_crops, 3] offsets for an input of ``shape`` [N, 1, D, H, W],
        each uniform in [0, side - side // 2]. In a data-parallel run
        (``replicas``) every rank draws the global batch's offsets and
        keeps its rows."""
        rp = self.replicas
        shape = sp.whole_shape(shape, rp)
        n = shape[0] * (1 if rp is None else rp.data_world)
        off = torch.stack(
            [torch.randint(0, s - s // 2 + 1, (n, self.n_crops),
                           generator=generator, device=device)
             for s in shape[2:]], dim=-1)
        return off if rp is None else rp.rows(off)

    def forward(self, x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        rp = self.replicas
        # a crop volume that stays whole is consumed alike on every rank
        sharded = sp.on(rp) and sp.shards(x.shape[3] // 2, rp)
        if sp.on(rp) and sp.is_sharded(x):
            x = (sp.gather_summed if sharded else sp.gather)(x, rp)
        n, c, d, h, w = x.shape
        if c != 1:
            raise ValueError(f"RandomCrop3D expects one channel, got {c}")
        if offsets.shape != (n, self.n_crops, 3):
            raise ValueError(f"RandomCrop3D: offsets {tuple(offsets.shape)} "
                             f"are not [{n}, {self.n_crops}, 3]")
        cd, ch, cw = d // 2, h // 2, w // 2
        lo, hi = sp.span(cd, rp) if sharded else (0, cd)
        dev = x.device
        off = offsets.to(dev)
        # flat index of crop (n, k)'s voxel (i, j, l): its corner's index
        # plus the voxel's offset inside a D x H x W volume
        corner = (off[..., 0] * h + off[..., 1]) * w + off[..., 2]
        inside = ((torch.arange(lo, hi, device=dev)[:, None, None] * h
                   + torch.arange(ch, device=dev)[None, :, None]) * w
                  + torch.arange(cw, device=dev)[None, None, :])
        idx = corner[..., None] + inside.reshape(1, 1, -1)
        out = x.reshape(n, -1).gather(1, idx.reshape(n, -1))
        return out.reshape(n, self.n_crops, hi - lo, ch, cw)

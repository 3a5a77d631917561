"""DCGAN-3D generator and discriminator family (NCDHW).

Counterparts of gan3d_tpu/models/dcgan.py:43-139 (reference dcgan.py):
the stage count follows ``cfg.resolution`` (Config.dcgan_*_channels), the
reference's topology at 128^3.

- G: a ConvTranspose3d stem k4/s1/p0 from 1^3 to 4^3, then k4/s2/p1
  ConvTranspose3d stages, each with BatchNorm3d and ReLU, then a
  ConvTranspose3d to one channel at full resolution and tanh. Conv weights
  N(0, 0.02), BN scales N(1, 0.02). ``--sagan``: SelfAttention3d after the
  stage whose output side is resolution/4 (never the stem).
- D, four variants, in this precedence:
  - msl: RandomCrop3D (128 half-size crops as channels), SN k4/s2/p1 convs
    over all stage widths but the last, each with LeakyReLU(0.1), then an
    SN 4^3 conv to 1; no attention even with ``--sagan``;
  - sngan / sagan: SN k4/s2/p1 convs with LeakyReLU(0.1); sagan adds
    SelfAttention3d after the stage whose output side is 8; then an SN 4^3
    conv to 1;
  - WGAN (default): plain k4/s2/p1 convs, each with LayerNormVolume and
    LeakyReLU(0.2), then a 4^3 conv to 1.
  D's convs have no bias; its output is [N, 1].

Both networks are one ``nn.Sequential`` ``main`` whose indices are the
reference's (gan3d_tpu/eval/export.py:115-201), parameterless ReLU,
LeakyReLU, Tanh and RandomCrop3D slots included, so converted JAX weights
and reference checkpoints load with ``strict=True``. Activations run in
``cfg.compute_dtype``; parameters, BN statistics and the spectral-norm
power iteration stay f32.

Under a model axis (``model_devices``, parallel/tp.py) the activations
stay channel-sharded between layers (``tp_local_activations``), and the
attention's projections are sharded by the rule as the JAX package's are:
its DCGAN names the block ``SelfAttention3d_0``, outside the rule's
"attn" match (``tp_replicated`` False).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models.biggan import compute_dtype
from gan3d_tpu_torch.nn.attention import SelfAttention3d
from gan3d_tpu_torch.nn.layers import Conv3d, ConvTranspose3d, SNConv3d
from gan3d_tpu_torch.nn.msl import RandomCrop3D
from gan3d_tpu_torch.nn.norm import BatchNorm3d, LayerNormVolume

STD = 0.02        # conv weights N(0, 0.02), BN scales N(1, 0.02)
N_CROPS = 128     # the msl D's crops (gan3d_tpu/models/dcgan.py:104)


def _attention(ch: int) -> SelfAttention3d:
    attn = SelfAttention3d(ch)
    attn.tp_replicated = False
    return attn


class Generator(nn.Module):
    tp_local_activations = True

    def __init__(self, cfg: Config):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        chans = cfg.dcgan_g_channels()
        layers = [ConvTranspose3d(cfg.z_size, chans[0], 4, 1, 0, std=STD),
                  BatchNorm3d(chans[0], std=STD), nn.ReLU()]
        res = 4
        for cin, cout in zip(chans[:-1], chans[1:]):
            res *= 2
            layers += [ConvTranspose3d(cin, cout, 4, 2, 1, std=STD),
                       BatchNorm3d(cout, std=STD), nn.ReLU()]
            if cfg.sagan and res == cfg.resolution // 4:
                layers.append(_attention(cout))
        layers += [ConvTranspose3d(chans[-1], 1, 4, 2, 1, std=STD), nn.Tanh()]
        self.main = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = z.reshape(z.shape[0], -1, 1, 1, 1).to(self.dtype)
        return self.main(z)


class Discriminator(nn.Module):
    tp_local_activations = True

    def __init__(self, cfg: Config):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.msl = cfg.msl
        chans = cfg.dcgan_d_channels()
        sn = dict(bias=False, std=STD)
        if cfg.msl:
            stages = chans[:max(1, len(chans) - 1)]
            layers, cin = [RandomCrop3D(N_CROPS)], N_CROPS
            for ch in stages:
                layers += [SNConv3d(cin, ch, 4, 2, 1, **sn),
                           nn.LeakyReLU(0.1)]
                cin = ch
            layers.append(SNConv3d(cin, 1, 4, 1, 0, **sn))
        elif cfg.sngan or cfg.sagan:
            layers, cin, res = [], 1, cfg.resolution
            for ch in chans:
                res //= 2
                layers += [SNConv3d(cin, ch, 4, 2, 1, **sn),
                           nn.LeakyReLU(0.1)]
                if cfg.sagan and res == 8:
                    layers.append(_attention(ch))
                cin = ch
            layers.append(SNConv3d(cin, 1, 4, 1, 0, **sn))
        else:
            layers, cin, res = [], 1, cfg.resolution
            for ch in chans:
                res //= 2
                layers += [Conv3d(cin, ch, 4, 2, 1, **sn),
                           LayerNormVolume((ch, res, res, res)),
                           nn.LeakyReLU(0.2)]
                cin = ch
            layers.append(Conv3d(cin, 1, 4, 1, 0, **sn))
        self.main = nn.Sequential(*layers)

    def draw_offsets(self, x: torch.Tensor,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        """The msl D's crop offsets for input ``x`` ([N, 128, 3] long)."""
        return self.main[0].draw_offsets(x.shape, generator, x.device)

    def forward(self, x: torch.Tensor, offsets: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """D(x) [N, 1]. The msl D crops at ``offsets``, which it requires
        (the train step draws them from its generator: ``draw_offsets``);
        the other variants take none."""
        h = x.to(self.dtype)
        layers = iter(self.main)
        if self.msl:
            if offsets is None:
                raise ValueError("the msl D needs its crop offsets "
                                 "(draw_offsets)")
            h = next(layers)(h, offsets)
        elif offsets is not None:
            raise ValueError("crop offsets given to a D without RandomCrop3D "
                             "(msl=False)")
        for layer in layers:
            h = layer(h)
        return h.reshape(h.shape[0], -1)

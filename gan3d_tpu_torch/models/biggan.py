"""BigGAN-Deep-3D / SNGAN-3D / SAGAN-3D generator and discriminator (NCDHW).

Counterparts of gan3d_tpu/models/biggan.py (reference biggan.py:8-119):
- default: one deep block per resolution; ``--biggan``: doubled blocks per
  stage (upsample on the 2nd G block, downsample on the 1st D block);
- ``--sagan`` / ``--biggan``: SelfAttention3d at 32^3 in G and 16^3 in D;
- ``--sngan``: spectral norm off in G, the D input conv and the D linear
  (the reference's inverted flag); the deep D blocks stay normalized.

G: snlinear z -> ch0 * 4^3, reshaped channel-major to a 4^3 grid, deep
blocks up to full resolution, BN + ReLU + snconv3d -> tanh. D: snconv3d
input conv, deep blocks down to 4^3, ReLU, global *sum* pool, snlinear -> 1.
Module names follow the reference's state_dict (``linear``,
``blocks.{i}.{j}``, ``output_layer.0/.2``, ``input_conv``), so converted
JAX weights and reference checkpoints load with ``strict=True``.

Activations run in ``cfg.compute_dtype``; parameters, BN statistics and
the spectral-norm power iteration stay f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.nn.attention import SelfAttention3d
from gan3d_tpu_torch.nn.blocks import DBlockDeep, GBlockDeep
from gan3d_tpu_torch.nn.layers import SNConv3d, SNLinear
from gan3d_tpu_torch.nn.norm import BatchNorm3d
from gan3d_tpu_torch.ops.conv3d import global_sum_pool


def compute_dtype(cfg: Config) -> torch.dtype:
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
        cfg.compute_dtype)
    if dt is None:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not in "
                         "(float32, bfloat16)")
    return dt


def _has_attention(cfg: Config, arch, idx: int) -> bool:
    return bool((cfg.sagan or cfg.biggan)
                and arch["attention"][arch["resolution"][idx]])


class Generator(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        arch = cfg.biggan_g_arch()
        plain = cfg.sngan
        self.dtype = compute_dtype(cfg)
        self.ch0 = arch["in_channels"][0]
        self.linear = SNLinear(cfg.z_size, self.ch0 * 64, plain=plain,
                               orthogonal=True)
        kw = dict(plain=plain, channel_ratio=cfg.channel_ratio)
        blocks = []
        for idx, (cin, cout) in enumerate(zip(arch["in_channels"],
                                              arch["out_channels"])):
            attn = ([SelfAttention3d(cout)] if _has_attention(cfg, arch, idx)
                    else [])
            if cfg.biggan:
                blocks.append(nn.ModuleList([GBlockDeep(cin, cin, **kw)]))
            blocks.append(nn.ModuleList(
                [GBlockDeep(cin, cout, upsample=True, **kw)] + attn))
        self.blocks = nn.ModuleList(blocks)
        cl = arch["out_channels"][-1]
        self.output_layer = nn.Sequential(
            BatchNorm3d(cl), nn.ReLU(),
            SNConv3d(cl, 1, 3, padding=1, plain=plain, orthogonal=True))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = z.reshape(z.shape[0], -1).to(self.dtype)
        h = self.linear(z).reshape(z.shape[0], self.ch0, 4, 4, 4)
        for stage in self.blocks:
            for mod in stage:
                h = mod(h)
        return torch.tanh(self.output_layer(h))


class Discriminator(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        arch = cfg.biggan_d_arch()
        self.dtype = compute_dtype(cfg)
        self.input_conv = SNConv3d(1, arch["in_channels"][0], 3, padding=1,
                                   plain=cfg.sngan, orthogonal=True)
        kw = dict(channel_ratio=cfg.channel_ratio)
        blocks = []
        for idx, (cin, cout) in enumerate(zip(arch["in_channels"],
                                              arch["out_channels"])):
            down = arch["downsample"][idx]
            stage = [DBlockDeep(cin, cout, downsample=down, **kw)]
            if cfg.biggan:
                stage.append(DBlockDeep(cout, cout, **kw))
            if _has_attention(cfg, arch, idx):
                stage.append(SelfAttention3d(cout))
            blocks.append(nn.ModuleList(stage))
        self.blocks = nn.ModuleList(blocks)
        self.linear = SNLinear(arch["out_channels"][-1], 1, plain=cfg.sngan,
                               orthogonal=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.input_conv(x.to(self.dtype))
        for stage in self.blocks:
            for mod in stage:
                h = mod(h)
        return self.linear(global_sum_pool(F.relu(h)))

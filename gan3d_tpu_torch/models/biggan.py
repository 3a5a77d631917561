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

``cfg.remat`` (gan3d_tpu/models/biggan.py:65-186) recomputes activations
in backward through ``nn/remat.py``, which steps the BN and SN state once:
``remat_scope="block"`` makes each deep block a group; ``"stage"`` each
stage (G: its one or two deep blocks, plus the out-head BN + ReLU + conv +
tanh at the last stage unless an attention block sits between them, else
the head alone; D: its deep blocks, plus the input conv at the first
stage), whose recompute checkpoints each block, the head and the input
conv again (``remat.nested``: backward holds one stage's block
boundaries at a time, so a stage group fits at least the batch a block
group does). ``SelfAttention3d`` stays outside every group, so the attention
kernels launch as often as without remat. Groups are formed in
``forward``: the module tree and its state_dict keys stay the same.

Under a model axis (``model_devices``, parallel/tp.py) the activations
stay channel-sharded between layers (``tp_local_activations``): G's first
linear writes its slice of the channel-major features, which is its
slice of the 4^3 grid's channels.

Under a space axis (``spatial_devices``, parallel/sp.py) the activations
are depth slabs: G's first linear runs whole on every rank and the 4^3
grid after the reshape keeps this rank's planes (``sp.cut``: the linear's
gradient is then a partial, the slab's rows), G's output is the rank's
slab of the volume, and D sums its pooled features over the space group
before the linear (whose gradient is then alike on every rank).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.nn import remat
from gan3d_tpu_torch.nn.attention import SelfAttention3d
from gan3d_tpu_torch.nn.blocks import DBlockDeep, GBlockDeep
from gan3d_tpu_torch.nn.layers import SNConv3d, SNLinear
from gan3d_tpu_torch.nn.norm import BatchNorm3d
from gan3d_tpu_torch.parallel import sp, tp


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


def _split(mods) -> tuple:
    """(the deep blocks, the attention block or None) of a stage."""
    attn = [m for m in mods if isinstance(m, SelfAttention3d)]
    return ([m for m in mods if not isinstance(m, SelfAttention3d)],
            attn[0] if attn else None)


class Generator(nn.Module):
    tp_local_activations = True

    def __init__(self, cfg: Config):
        super().__init__()
        arch = cfg.biggan_g_arch()
        plain = cfg.sngan
        self.dtype = compute_dtype(cfg)
        self.remat = remat.scope(cfg.remat, cfg.remat_scope)
        self.per_stage = 2 if cfg.biggan else 1  # entries of self.blocks
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
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = z.reshape(z.shape[0], -1).to(self.dtype)
        h = self.linear(z)
        rp = self.replicas
        if tp.on(rp) and self.ch0 % rp.model:
            h = tp.layout(h, self.ch0 * 64, False, rp)
        h = sp.cut(h.reshape(z.shape[0], -1, 4, 4, 4), rp, self.linear)
        head = [self.output_layer, torch.tanh]
        n_stages = len(self.blocks) // self.per_stage
        for idx in range(n_stages):
            entries = self.blocks[idx * self.per_stage:
                                  (idx + 1) * self.per_stage]
            deep, attn = _split([m for stage in entries for m in stage])
            if self.remat == "stage":
                fold = idx == n_stages - 1 and attn is None
                h = remat.nested([[b] for b in deep]
                                 + ([head] if fold else []), h)
                if fold:
                    return h
            else:
                for blk in deep:
                    h = remat.sequential([blk], h, self.remat == "block")
            if attn is not None:
                h = attn(h)
        return remat.sequential(head, h, self.remat == "stage")


class Discriminator(nn.Module):
    tp_local_activations = True

    def __init__(self, cfg: Config):
        super().__init__()
        arch = cfg.biggan_d_arch()
        self.dtype = compute_dtype(cfg)
        self.remat = remat.scope(cfg.remat, cfg.remat_scope)
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
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        for idx, stage in enumerate(self.blocks):
            deep, attn = _split(stage)
            first = [self.input_conv] if idx == 0 else []
            if self.remat == "stage":
                h = remat.nested([[f] for f in first + deep], h)
            else:
                for f in first:
                    h = f(h)
                for blk in deep:
                    h = remat.sequential([blk], h, self.remat == "block")
            if attn is not None:
                h = attn(h)
        return self.linear(sp.global_sum_pool(F.relu(h), self.replicas))

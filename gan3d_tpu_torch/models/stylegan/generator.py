"""StyleGAN2-3D synthesis network and generator (NCDHW).

Counterpart of gan3d_tpu/models/stylegan/generator.py (reference
stylegan.py:548-718). Blocks ``b{res}`` from 4^3 to the resolution with
``synthesis_channels`` (min(channel_base // res, 512), channel_base =
cfg.filterG); the 4^3 block starts from a learned const and has one
modulated conv (conv1), the others an up-2 conv0 and a conv1; each block
adds its toRGB output (f32) to the running image, FIR-upsampled 2x with
the gain up ** 3 (the 'skip' architecture). The ws bookkeeping is the
reference's: a block reads num_conv + num_torgb ws and advances by num_conv
(stylegan.py:683-687). The image ends in tanh.

``Generator`` = mapping + synthesis, returning (img, ws); ``map_ws`` and
``synthesize`` run the halves (the loss's style mixing and path-length
penalty). Noise: ``noise`` is a list of standard-normal draws, one per
SynthesisLayer in ``noise_shapes`` order, else the synthesis draws them
all from ``generator`` in that order before its first block (the values
each layer would draw in turn). The mapping is f32; the synthesis runs in
cfg.compute_dtype, its image in f32. ``cfg.remat`` makes each synthesis
block a group recomputed in backward (nn/remat.py;
gan3d_tpu/models/stylegan/generator.py:140); the noise is its input.

Under a space axis (parallel/sp.py) the synthesis writes this rank's
depth slab of the image. The 4^3 const is cut to the slab where the rule
shards 4^3 (S = 2; ``sp.cut``, so its gradient is partial); at S = 4 the
4^3 block runs whole on every rank and the first up layer's output and
the upsampled image are split to 8^3 slabs (``sp.form`` after every
layer and image upsample). The layers and the image's skip upsample run
on slabs (layers.py, resample.py); the mapping and ws stay whole, and
``noise_shapes`` stays the global shape: each layer slices its whole
draw.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models.biggan import compute_dtype
from gan3d_tpu_torch.models.stylegan.layers import OutBlock, SynthesisLayer
from gan3d_tpu_torch.models.stylegan.mapping import MappingNetwork
from gan3d_tpu_torch.models.stylegan.resample import setup_filter, upfirdn3d
from gan3d_tpu_torch.nn import remat
from gan3d_tpu_torch.parallel import sp, tp

Noise = Optional[Sequence[torch.Tensor]]
CHANNEL_MAX = 512


def synthesis_channels(channel_base: int, resolution: int) -> Dict[int, int]:
    res_log2 = int(np.log2(resolution))
    chans = {2 ** i: min(channel_base // (2 ** i), CHANNEL_MAX)
             for i in range(2, res_log2 + 1)}
    if chans[resolution] < 1:
        # the reference's channel table rounds to 0 channels here and torch
        # fails deep inside conv3d (stylegan.py:660-662)
        raise ValueError(
            f"StyleGAN channel table hits 0 channels at resolution "
            f"{resolution} with filterG/filterD={channel_base}; use "
            f"filter >= resolution (reference default: 128).")
    return chans


class SynthesisBlock(nn.Module):
    """``in_channels`` 0 marks the 4^3 block (the const, no conv0). Every
    block has a toRGB (the 'skip' architecture) to one image channel."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels, self.dtype = in_channels, dtype
        kw = dict(w_dim=w_dim, resolution=resolution)
        if in_channels == 0:
            self.const = nn.Parameter(torch.randn(out_channels, resolution,
                                                  resolution, resolution))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=2, **kw)
        self.conv1 = SynthesisLayer(out_channels, out_channels, **kw)
        self.num_conv = 1 if in_channels == 0 else 2
        self.torgb = OutBlock(out_channels, 1, w_dim)
        self.register_buffer("resample_filter", setup_filter(),
                             persistent=False)
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def layers(self) -> List[SynthesisLayer]:
        return [self.conv1] if self.in_channels == 0 else [self.conv0,
                                                           self.conv1]

    def forward(self, x: Optional[torch.Tensor], ws: torch.Tensor,
                img: Optional[torch.Tensor], noise: Noise = None,
                generator: Optional[torch.Generator] = None,
                noise_mode: str = "random", fused_modconv: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        rp = self.replicas
        if self.in_channels == 0:
            const = self.const
            if getattr(self, "tp_span", None) is not None:  # sharded
                const = tp.gather(const, rp, dim=0)
            x = const[None].expand(ws.shape[0], *const.shape)
            if sp.on(rp):
                x = sp.cut(x, rp, self.const)
        x = x.to(self.dtype)
        for j, layer in enumerate(self.layers()):
            x = sp.form(layer(x, ws[:, j], None if noise is None else noise[j],
                              generator, noise_mode, fused_modconv), rp)
        if img is not None:
            # the reference inlines upsample2x's padding (stylegan.py:620-634)
            f = self.resample_filter
            fw, up = f.shape[0], 2
            p = [(fw + up - 1) // 2, (fw - up) // 2] * 3
            slab = sp.on(rp) and sp.is_sharded(img)
            img = sp.form(upfirdn3d(img, f, up=up, padding=p, gain=up ** 3,
                                    rp=rp if slab else None), rp)
        y = self.torgb(x, ws[:, self.num_conv],
                       fused_modconv=fused_modconv).float()
        return x, (img + y if img is not None else y)


class SynthesisNetwork(nn.Module):
    def __init__(self, w_dim: int = 512, img_resolution: int = 128,
                 channel_base: int = 4096,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.replicas = None    # parallel.Replicas, set by parallel.attach
        chans = synthesis_channels(channel_base, img_resolution)
        self.block_resolutions = [
            2 ** i for i in range(2, int(np.log2(img_resolution)) + 1)]
        for res in self.block_resolutions:
            setattr(self, f"b{res}", SynthesisBlock(
                chans[res // 2] if res > 4 else 0, chans[res], w_dim, res,
                dtype=dtype))
        # every block's convs, and the last block's toRGB
        self.num_ws = sum(b.num_conv for b in self.blocks()) + 1

    def blocks(self) -> List[SynthesisBlock]:
        return [getattr(self, f"b{res}") for res in self.block_resolutions]

    def noise_shapes(self, n: int) -> List[Tuple[int, ...]]:
        """The shape of each SynthesisLayer's noise, in the order the
        layers (and the JAX package's) draw it."""
        return [layer.noise_shape(n) for b in self.blocks()
                for layer in b.layers()]

    def forward(self, ws: torch.Tensor, noise: Noise = None,
                generator: Optional[torch.Generator] = None,
                noise_mode: str = "random",
                fused_modconv: bool = False) -> torch.Tensor:
        ws = ws.float()
        if noise is None and noise_mode == "random":
            # drawn here, never inside a remat group, whose recompute would
            # draw again
            if generator is None:
                raise ValueError("noise_mode='random' needs the noise or a "
                                 "generator to draw it from")
            # in a data-parallel run, this rank's rows of the global
            # batch's draws
            rp = self.replicas
            n = ws.shape[0] * (1 if rp is None else rp.data_world)
            noise = [torch.randn(s, generator=generator, device=ws.device)
                     for s in self.noise_shapes(n)]
            if rp is not None:
                noise = [rp.rows(t) for t in noise]
        x = img = None
        w_idx = n_idx = 0
        for block in self.blocks():
            take = block.num_conv + 1
            k = len(block.layers())
            args = (x, ws[:, w_idx:w_idx + take], img,
                    None if noise is None else noise[n_idx:n_idx + k],
                    generator, noise_mode, fused_modconv)
            x, img = (remat.checkpoint(block, [block], *args) if self.remat
                      else block(*args))
            w_idx += block.num_conv
            n_idx += k
        return torch.tanh(img)


class Generator(nn.Module):
    """StyleGAN2 G (reference stylegan.py:697-718); returns (img, ws)."""

    def __init__(self, cfg: Config, w_dim: int = 512):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, img_resolution=cfg.resolution,
            channel_base=cfg.filterG, dtype=self.dtype, remat=cfg.remat)
        self.mapping = MappingNetwork(z_dim=cfg.z_size, w_dim=w_dim,
                                      num_ws=self.synthesis.num_ws)

    def forward(self, z: torch.Tensor, noise: Noise = None,
                generator: Optional[torch.Generator] = None,
                noise_mode: str = "random", truncation_psi: float = 1.0,
                fused_modconv: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if fused_modconv is None:
            # the reference's default (stylegan.py:601): fused when not
            # training, at full precision or batch 1
            fused_modconv = (not self.training) and (
                self.dtype == torch.float32 or z.shape[0] == 1)
        ws = self.mapping(z, truncation_psi=truncation_psi)
        img = self.synthesis(ws, noise, generator, noise_mode, fused_modconv)
        return img, ws

    def map_ws(self, z: torch.Tensor) -> torch.Tensor:
        return self.mapping(z)

    def synthesize(self, ws: torch.Tensor, noise: Noise = None,
                   generator: Optional[torch.Generator] = None,
                   noise_mode: str = "random",
                   fused_modconv: bool = False) -> torch.Tensor:
        return self.synthesis(ws, noise, generator, noise_mode,
                              fused_modconv)

"""StyleGAN-1-3D generator (AdaIN), NCDHW.

Counterpart of gan3d_tpu/models/stylegan/stylegan1.py (reference
stylegan.py:931-1148):

- ``ada_in``: instance-normalize the content over D, H, W and re-scale it
  with a style [N, 2C] (the first C means, the last C stds); the variance
  is unbiased (torch ``.var``'s default, times n / (n - 1)), eps 1e-5
  inside the sqrt; math in f32, the result in the content's dtype. This is
  the two-pass form the JAX package runs off the TPU (stylegan1.py:40-86);
  its one-pass ``fast_adain`` lowering is exact algebra, so the knob is
  accepted and runs this form;
- the mapping ``latentMapping``: 8 x (Linear(z, z), LeakyReLU 0.2) in f32;
- a 4^3 block of ones with z channels as the input, the affines ``A{i}``
  (Linear(w -> 2 * channels), on the f32 w) before every AdaIN, the k3
  convs ``C{i}`` (no bias, each followed by LeakyReLU 0.2) through the
  port's ``Conv3d``, so the ``wide_conv`` / ``fast_dw`` routes take them,
  trilinear 2x upsampling (``ops/conv3d.upsample_trilinear3d``), then
  ``C_out`` (one channel) and tanh;
- the stage channels: 512 halved per stage with a floor of 16, whatever
  ``filterG`` (stylegan1.py:89-96); at 64^3 512, 256, 128, 64, 32;
- style mixing in train mode (stylegan1.py:127-146): one swap point from
  randint(0, 6) and one permutation of the batch per forward; w is
  replaced by w[perm] at the mixing site whose counter equals the swap
  point. A network with k stages has k sites (0 .. k-1: 5 at 64^3), so a
  swap point of k or more never mixes, as in the JAX package. In a
  data-parallel run (``replicas``) the permutation is of the global batch
  (stylegan1.py:132-144): every rank draws the same one, gathers w
  (differentiably) and keeps its rows of w[perm].

State_dict keys are the reference's (gan3d_tpu/eval/export.py:342-357):
``latentMapping.{0,2,..,14}``, ``A{i}``, ``C{i}.0``, ``C_out.0``.

Under a space axis (parallel/sp.py) G writes this rank's depth slab. The
4^3 ones are cut to the slab where the rule shards 4^3 (S = 2); at S = 4
the 4^3 stage runs whole and its upsample is split to 8^3 slabs
(``sp.form``). On a slab, ``ada_in``'s mean and variance sum over space
(the unbiased factor from the whole volume's count) and its affine reads
the whole w through ``tp.copy`` over the space group (its gradient summed
there, the affine's marked partial); the trilinear upsample takes a
one-plane halo each side that repeats the end plane at the volume's two
ends (``align_corners=False`` clamps there) and keeps twice the slab; the
k3 convs take their halo in ``nn/layers.py`` Conv3d (``sp.conv3d``,
the K4 / K3 routes on the halo'd slab).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models.biggan import compute_dtype
from gan3d_tpu_torch.models.stylegan.loss import Draws
from gan3d_tpu_torch.nn.layers import Conv3d, Linear
from gan3d_tpu_torch.ops.conv3d import upsample_trilinear3d
from gan3d_tpu_torch.parallel import sp, tp

MAPPING_LAYERS = 8
MIX_POINTS = 6  # the swap point is drawn from [0, MIX_POINTS)


def ada_in(content: torch.Tensor, style: torch.Tensor,
           eps: float = 1e-5, rp=None) -> torch.Tensor:
    """content [N, C, D, H, W], style [N, 2C] -> [N, C, D, H, W] in the
    content's dtype. With ``rp`` the content is a depth slab and the
    statistics are the whole volume's (``sp.allsum`` of the slabs')."""
    c = content.shape[1]
    x32 = content.float()
    n_el = content.shape[2] * content.shape[3] * content.shape[4]
    s_mean = style[:, :c].float().reshape(-1, c, 1, 1, 1)
    s_std = style[:, c:].float().reshape(-1, c, 1, 1, 1)
    dims = (2, 3, 4)
    if rp is not None:
        n_el *= rp.space
        mean = sp.allsum(x32.sum(dim=dims, keepdim=True), rp) / n_el
        var = sp.allsum(((x32 - mean) ** 2).sum(dim=dims, keepdim=True),
                        rp) / n_el * (n_el / (n_el - 1))
    else:
        mean = x32.mean(dim=dims, keepdim=True)
        var = ((x32 - mean) ** 2).mean(dim=dims, keepdim=True) \
            * (n_el / (n_el - 1))
    normed = (x32 - mean) / torch.sqrt(var + eps)
    return (normed * s_std + s_mean).to(content.dtype)


def upsample2x(x: torch.Tensor, rp=None) -> torch.Tensor:
    """The G's trilinear 2x upsample, formed by the rule under a space
    axis; a depth slab's takes a one-plane halo each side (the end plane
    repeated at the volume's ends) and keeps its middle 2n planes."""
    if sp.on(rp) and sp.is_sharded(x):
        x = upsample_trilinear3d(sp.halo(x, 1, 1, rp, edge=True), 2)
        return x[:, :, 2:-2]
    return sp.form(upsample_trilinear3d(x, 2), rp)


def stage_channels(resolution: int) -> List[int]:
    """Base channels per upsample stage: 512 halved per stage, floor 16."""
    n_up, r = 0, resolution
    while r > 4:
        r //= 2
        n_up += 1
    return [max(512 >> i, 16) for i in range(n_up + 1)]


def _lecun(layer: nn.Module) -> nn.Module:
    """N(0, 1 / fan_in) weights and zero biases: the scale of the JAX
    package's lecun_normal init."""
    fan_in = layer.weight[0].numel()
    nn.init.normal_(layer.weight, 0.0, 1.0 / math.sqrt(fan_in))
    if getattr(layer, "bias", None) is not None:
        nn.init.zeros_(layer.bias)
    return layer


class StyleGAN1Generator(nn.Module):
    def __init__(self, cfg: Config, style_mixing: bool = True):
        super().__init__()
        nz = cfg.z_size
        self.dtype = compute_dtype(cfg)
        self.style_mixing = style_mixing
        self.replicas = None    # parallel.Replicas, set by parallel.attach
        mapping = []
        for _ in range(MAPPING_LAYERS):
            mapping += [_lecun(Linear(nz, nz)), nn.LeakyReLU(0.2)]
        self.latentMapping = nn.Sequential(*mapping)
        chans = self.chans = stage_channels(cfg.resolution)
        # the affines' channels and the convs' (in, out), in call order: the
        # 4^3 stage reads z channels, a middle stage has two convs, the
        # last stage one
        affines = [nz]
        convs = [(nz, chans[0])]
        for stage in range(1, len(chans) - 1):
            affines += [chans[stage - 1], chans[stage]]
            convs += [(chans[stage - 1], chans[stage]),
                      (chans[stage], chans[stage])]
        affines += [chans[-2], chans[-1]]
        convs += [(chans[-2], chans[-1])]
        for i, ch in enumerate(affines, start=1):
            setattr(self, f"A{i}", _lecun(Linear(nz, 2 * ch)))
        for i, (ci, co) in enumerate(convs, start=1):
            setattr(self, f"C{i}", nn.Sequential(
                _lecun(Conv3d(ci, co, 3, 1, 1, bias=False)),
                nn.LeakyReLU(0.2)))
        self.C_out = nn.Sequential(_lecun(Conv3d(chans[-1], 1, 3, 1, 1,
                                                 bias=False)))

    @property
    def n_mix_sites(self) -> int:
        return len(self.chans)

    def forward(self, z: torch.Tensor, draws: Optional[Draws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z [N, z] -> image [N, 1, R, R, R] in the compute dtype. In train
        mode the mixing draws come from ``draws``, else from
        ``generator``."""
        z = z.reshape(z.shape[0], -1)
        n = z.shape[0]
        rp = self.replicas
        w = self.latentMapping(z.float())
        mix = None
        if self.style_mixing and self.training:
            draws = draws or Draws(z.device, generator)
            # a permutation of the global batch (every rank draws the same)
            mix = (draws.randint(0, MIX_POINTS),
                   draws.permutation(n * (1 if rp is None else rp.data_world)))
        site = 0

        def maybe_mix(w: torch.Tensor) -> torch.Tensor:
            nonlocal site
            if mix is None:
                return w
            shuffled = (w[mix[1]] if rp is None
                        else rp.rows(rp.all_gather(w)[mix[1]]))
            out = torch.where(mix[0] == site, shuffled, w)
            site += 1
            return out

        a_i = c_i = 0

        def style(h: torch.Tensor) -> torch.Tensor:
            nonlocal a_i
            a_i += 1
            affine, v = getattr(self, f"A{a_i}"), w
            slab = sp.on(rp) and sp.is_sharded(h)
            if slab:  # a whole style that meets this rank's slab
                sp.mark(affine)
                v = tp.copy(w, rp.space_axis)
            return ada_in(h, affine(v), rp=rp if slab else None)

        def conv(h: torch.Tensor) -> torch.Tensor:
            nonlocal c_i
            c_i += 1
            return getattr(self, f"C{c_i}")(h)

        h = torch.ones((n, z.shape[1], 4, 4, 4), dtype=self.dtype,
                       device=z.device)
        if sp.on(rp):
            h = sp.cut(h, rp)
        h = conv(style(h))
        w = maybe_mix(w)
        for _ in range(1, len(self.chans) - 1):
            h = conv(upsample2x(style(h), rp))
            h = conv(style(h))
            w = maybe_mix(w)
        h = conv(upsample2x(style(h), rp))
        w = maybe_mix(w)
        return torch.tanh(self.C_out(style(h)))

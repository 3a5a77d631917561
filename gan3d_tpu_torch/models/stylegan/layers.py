"""StyleGAN2 primitive layers (NCDHW).

Counterparts of gan3d_tpu/models/stylegan/layers.py (reference
stylegan.py:103-124 bias_act, 298-327 FullyConnectedLayer, 396-444
modulated_conv3d, 446-546 Conv3dLayer / SynthesisLayer / OutBlock). The
parameter names and layouts are the reference's torch ones
(gan3d_tpu/eval/export.py:259-339): conv weights [O, I, k, k, k], FC
weights [O, I].

dtype points, as in the JAX package: the affines (styles) and the
demodulation coefficients are f32; the conv runs in the input's dtype
(the compute dtype), with the weight, styles and coefficients cast to it.
The JAX ``c1act`` knob (a TPU layout rewrite, ROADMAP A8) has no
counterpart: the plain elementwise op runs. The layers take only the
settings the StyleGAN2 networks use (lrelu or linear activations, the
[1, 3, 3, 1] FIR, 3^3 synthesis convs with noise, 1^3 toRGB).

Under a model axis (parallel/tp.py) a layer whose weight the rule shards
computes its output channels' slice from its whole inputs (each through
``tp.copy``) and gathers it at once: the StyleGAN families keep sharded
parameters and Adam state, and whole activations (``tp_local_activations``
unset). Bias, noise and activation follow the gather.

Under a space axis (parallel/sp.py) a layer whose input is a depth slab
(told at its input) runs its conv on the halo'd slab (resample.py) and
its pointwise ops on the slab: its parameters are marked as used on
slabs (``sp.mark``: the conv weight, the bias, ``noise_strength`` and
the affine), the whole ws it reads goes through ``tp.copy`` over the
space group (the styles and demodulation coefficients are whole [N, C]
values that meet this rank's slab only, so the gradient of ws is summed
over space and the mapping's stays whole), and the layer's whole noise
draw is sliced to the output slab. A discriminator layer's output is
then formed by the rule (``sp.form``: gathered where its side runs
whole). A layer whose input is whole runs as in one process.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gan3d_tpu_torch.models.stylegan.resample import (conv3d_resample,
                                                      setup_filter)
from gan3d_tpu_torch.parallel import sp, tp


def _sharded(layer: nn.Module):
    """The layer's Replicas when its weight is sharded, else None."""
    rp = layer.replicas
    return (rp if tp.on(rp) and getattr(layer, "tp_span", None) is not None
            else None)


def _on_slab(layer: nn.Module, x: torch.Tensor, w=None):
    """(the layer's Replicas when ``x`` is a depth slab, else None; ``w``
    made ready to meet the slab). A layer on a slab has its parameters
    marked (their gradients are partial) and its whole ``w`` copied over
    the space group (its gradient summed there)."""
    rp = layer.replicas
    if not (sp.on(rp) and sp.is_sharded(x)):
        return None, w
    sp.mark(layer)
    return rp, None if w is None else tp.copy(w, rp.space_axis)


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None,
             act: str = "linear") -> torch.Tensor:
    """Add a per-channel bias (dim 1) in x's dtype, then activate:
    "linear" or "lrelu" (slope 0.2, no gain, as the JAX package's)."""
    if b is not None:
        x = x + b.to(x.dtype).reshape([1, -1] + [1] * (x.ndim - 2))
    if act == "lrelu":
        return F.leaky_relu(x, 0.2)
    if act != "linear":
        raise ValueError(f"activation {act!r} not in ('linear', 'lrelu')")
    return x


def normalize_2nd_moment(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


class FullyConnectedLayer(nn.Module):
    """FC with the runtime weight gain lr_mult / sqrt(fan_in); the weight is
    stored divided by lr_mult and the bias multiplied by it at run time
    (reference stylegan.py:309-312)."""

    def __init__(self, in_features: int, out_features: int,
                 activation: str = "linear", lr_multiplier: float = 1.0,
                 bias_init: float = 0.0):
        super().__init__()
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight = nn.Parameter(
            torch.randn(out_features, in_features) / lr_multiplier)
        self.bias = nn.Parameter(torch.full((out_features,),
                                            float(bias_init)))
        self.weight_gain = lr_multiplier / np.sqrt(in_features)
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rp = _sharded(self)
        w = (self.weight * self.weight_gain).to(x.dtype)
        if rp is None:
            y = F.linear(x, w)
        else:
            y = tp.gather(F.linear(tp.copy(x, rp), w), rp)
        b = self.bias
        if self.lr_multiplier != 1:
            b = b * self.lr_multiplier
        return bias_act(y, b, self.activation)


def modulated_conv3d(x: torch.Tensor, weight: torch.Tensor,
                     styles: torch.Tensor,
                     noise: Optional[torch.Tensor] = None, up: int = 1,
                     padding: int = 0,
                     resample_filter: Optional[torch.Tensor] = None,
                     demodulate: bool = True,
                     fused: bool = False, rp=None) -> torch.Tensor:
    """StyleGAN2 modulated conv: x [N, Cin, D, H, W], weight [Cout, Cin, k,
    k, k], styles [N, Cin], noise broadcast over channels. The weight is
    correlated (flip_weight) at up == 1 and convolved when upsampling, as
    the reference's SynthesisLayer calls it.

    ``fused=False`` (the training path, stylegan.py:426-435): scale the
    input by the styles, convolve with the shared weight, scale the output
    by the f32 demodulation coefficients; the noise is added as
    ``noise + x * dcoefs``. ``fused=True`` (stylegan.py:438-445, used when
    not training): per-sample weights, one grouped conv with groups = N.
    With ``rp`` x is a depth slab: the conv takes its halo and the output
    is this rank's slab (``noise`` must be the slab's).
    """
    n = x.shape[0]
    cout, cin = weight.shape[:2]
    kw = dict(f=resample_filter, up=up, padding=padding,
              flip_weight=up == 1, rp=rp)

    if fused:
        w = weight.float()[None] * styles.float().reshape(n, 1, cin, 1, 1, 1)
        if demodulate:
            d = torch.rsqrt(torch.sum(w * w, dim=(2, 3, 4, 5)) + 1e-8)
            w = w * d.reshape(n, cout, 1, 1, 1, 1)
        y = conv3d_resample(x.reshape(1, n * cin, *x.shape[2:]),
                            w.reshape(n * cout, cin, *w.shape[3:])
                            .to(x.dtype), groups=n, **kw)
        y = y.reshape(n, cout, *y.shape[2:])
        if noise is not None:
            y = y + noise.to(y.dtype)
        return y

    dcoefs = None
    if demodulate:
        w32 = weight.float()
        s32 = styles.float()
        dcoefs = torch.rsqrt(
            (s32 * s32) @ (w32 * w32).sum(dim=(2, 3, 4)).t() + 1e-8)
    x = x * styles.to(x.dtype).reshape(n, cin, 1, 1, 1)
    x = conv3d_resample(x, weight.to(x.dtype), **kw)
    if demodulate:
        x = x * dcoefs.to(x.dtype).reshape(n, cout, 1, 1, 1)
        if noise is not None:
            x = noise.to(x.dtype) + x
    elif noise is not None:
        x = x + noise.to(x.dtype)
    return x


class Conv3dLayer(nn.Module):
    """Plain conv + FIR downsample + bias_act (reference stylegan.py
    :446-487); the discriminator's layer."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool = True, activation: str = "linear",
                 down: int = 1):
        super().__init__()
        k = kernel_size
        self.activation, self.down, self.padding = activation, down, k // 2
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels, k,
                                               k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.weight_gain = 1.0 / np.sqrt(in_channels * k ** 3)
        self.register_buffer("resample_filter", setup_filter(),
                             persistent=False)
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        rp = _sharded(self)
        srp, _ = _on_slab(self, x)
        y = conv3d_resample(x if rp is None else tp.copy(x, rp),
                            (self.weight * self.weight_gain).to(x.dtype),
                            f=self.resample_filter, down=self.down,
                            padding=self.padding, rp=srp)
        if rp is not None:
            y = tp.gather(y, rp)
        y = bias_act(y, self.bias, self.activation)
        if gain != 1.0:
            y = y * gain
        return y if srp is None else sp.form(y, srp)


class SynthesisLayer(nn.Module):
    """Modulated conv with per-layer noise (reference stylegan.py:489-532).

    ``noise`` is the layer's standard-normal draw [N, 1, r, r, r] (f32),
    scaled here by ``noise_strength``; with noise_mode="random" and no
    ``noise`` it is drawn from ``generator``, which must then be given (no
    draw comes from the global RNG). The reference's 2-D [res, res]
    ``noise_const`` buffer (stylegan.py:515) is carried so that its
    state_dicts load strictly; noise_mode="const", which reads it, has
    no caller in either package and is not ported.
    """

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, up: int = 1):
        super().__init__()
        self.resolution, self.up = resolution, up
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels, 3,
                                               3, 3))
        self.register_buffer("noise_const",
                             torch.randn(resolution, resolution))
        self.noise_strength = nn.Parameter(torch.zeros(()))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("resample_filter", setup_filter(),
                             persistent=False)
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def noise_shape(self, n: int):
        r = self.resolution
        return (n, 1, r, r, r)

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                noise_mode: str = "random",
                fused_modconv: bool = False) -> torch.Tensor:
        if noise_mode == "const":
            raise NotImplementedError(
                "noise_mode='const' is not ported: no caller in either "
                "package (ROADMAP.md queue A, deferred)")
        if noise_mode != "random":
            raise ValueError(f"noise_mode {noise_mode!r} not in ('random', "
                             "'const')")
        if noise is None:
            if generator is None:
                raise ValueError("noise_mode='random' needs the noise or a "
                                 "generator to draw it from")
            noise = torch.randn(self.noise_shape(x.shape[0]),
                                generator=generator, device=x.device)
        srp, w = _on_slab(self, x, w)
        if srp is not None:  # the output slab's planes of the whole draw
            noise = noise[:, :, slice(*sp.span(self.resolution, srp))]
        styles = self.affine(w.float())
        noise = noise.float() * self.noise_strength
        rp = _sharded(self)
        if rp is None:
            y = modulated_conv3d(x, self.weight, styles, noise=noise,
                                 up=self.up, padding=1,
                                 resample_filter=self.resample_filter,
                                 fused=fused_modconv, rp=srp)
        else:  # the noise meets the gathered channels (one sum, exact)
            y = tp.gather(modulated_conv3d(
                tp.copy(x, rp), self.weight, tp.copy(styles, rp), up=self.up,
                padding=1, resample_filter=self.resample_filter,
                fused=fused_modconv), rp)
            y = y + noise.to(y.dtype)
        return bias_act(y, self.bias, "lrelu")


class OutBlock(nn.Module):
    """toRGB: a modulated 1x1x1 conv without demodulation, its styles
    multiplied by the weight gain (reference stylegan.py:534-546)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int):
        super().__init__()
        self.weight_gain = 1.0 / np.sqrt(in_channels)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels, 1,
                                               1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                fused_modconv: bool = False) -> torch.Tensor:
        _, w = _on_slab(self, x, w)
        styles = self.affine(w.float()) * self.weight_gain
        y = modulated_conv3d(x, self.weight, styles, demodulate=False,
                             fused=fused_modconv)
        return bias_act(y, self.bias)

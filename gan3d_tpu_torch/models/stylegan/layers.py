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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gan3d_tpu_torch.models.stylegan.resample import (conv3d_resample,
                                                      setup_filter)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, (self.weight * self.weight_gain).to(x.dtype))
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
                     fused: bool = False) -> torch.Tensor:
    """StyleGAN2 modulated conv: x [N, Cin, D, H, W], weight [Cout, Cin, k,
    k, k], styles [N, Cin], noise broadcast over channels. The weight is
    correlated (flip_weight) at up == 1 and convolved when upsampling, as
    the reference's SynthesisLayer calls it.

    ``fused=False`` (the training path, stylegan.py:426-435): scale the
    input by the styles, convolve with the shared weight, scale the output
    by the f32 demodulation coefficients; the noise is added as
    ``noise + x * dcoefs``. ``fused=True`` (stylegan.py:438-445, used when
    not training): per-sample weights, one grouped conv with groups = N.
    """
    n = x.shape[0]
    cout, cin = weight.shape[:2]
    kw = dict(f=resample_filter, up=up, padding=padding,
              flip_weight=up == 1)

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

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        y = conv3d_resample(x, (self.weight * self.weight_gain).to(x.dtype),
                            f=self.resample_filter, down=self.down,
                            padding=self.padding)
        y = bias_act(y, self.bias, self.activation)
        if gain != 1.0:
            y = y * gain
        return y


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
        styles = self.affine(w.float())
        y = modulated_conv3d(x, self.weight, styles,
                             noise=noise.float() * self.noise_strength,
                             up=self.up, padding=1,
                             resample_filter=self.resample_filter,
                             fused=fused_modconv)
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

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                fused_modconv: bool = False) -> torch.Tensor:
        styles = self.affine(w.float()) * self.weight_gain
        y = modulated_conv3d(x, self.weight, styles, demodulate=False,
                             fused=fused_modconv)
        return bias_act(y, self.bias)

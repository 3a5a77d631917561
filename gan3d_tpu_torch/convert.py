"""Carry JAX-package weights across: variable trees -> the port's state_dicts.

``from_jax_variables(variables, cfg, which)`` takes the JAX package's
``{"params", "batch_stats", "spectral"}`` trees of one network of the
BigGAN, DCGAN or hybrid family (as numpy arrays) and returns the
state_dict of the port's module of the same config, which loads with
``strict=True``. The key names and layouts are the reference's torch ones
(the same mapping as gan3d_tpu/eval/export.py:59-252):

- conv kernel [kd, kh, kw, I, O]  -> weight [O, I, kd, kh, kw]
- transposed conv kernel          -> weight [I, O, kd, kh, kw] (no flip)
- linear kernel [I, O]            -> weight [O, I]
- spectral {u, v}                 -> ``parametrizations.weight.original``,
                                     ``.0._u``, ``.0._v``
- BN scale/bias + batch_stats     -> weight/bias/running_mean/running_var
                                     (+ num_batches_tracked = 0)
- LayerNorm scale/bias [D,H,W,C]  -> weight/bias [C, D, H, W]

The DCGAN networks are ``main.{i}`` Sequentials whose indices count the
parameterless ReLU, LeakyReLU, Tanh and RandomCrop3D slots (export.py
:115-201); the hybrid is the BigGAN G and the DCGAN D.

StyleGAN2 (export.py:259-339, ``export_stylegan2_g`` / ``export_stylegan_d``):
the raw style-conv weights [k, k, k, I, O] -> [O, I, k, k, k], the FC
weights [I, O] -> [O, I] (stored divided by lr_mult, as both packages
keep them), G's 4^3 const [4, 4, 4, C] -> [C, 4, 4, 4], ``mapping.w_avg``
from the ``moving`` collection (zeros without one), and each
SynthesisLayer's 2-D [res, res] ``noise_const``, which the JAX G does not
carry: standard normals from numpy's default_rng(0) in block order, the
exporter's draw. D's epilogue FC weight is permuted from the JAX NDHWC
flatten to the NCDHW one.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from gan3d_tpu_torch.config import Config

Tree = Mapping[str, Any]
StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    # np.array copies: the state_dict must not alias the caller's buffers.
    return torch.from_numpy(np.array(x, np.float32))


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _weight(sd: StateDict, prefix: str, w: np.ndarray,
            spectral: Optional[Tree]) -> None:
    if spectral:
        sd[_key(prefix, "parametrizations.weight.original")] = _t(w)
        sd[_key(prefix, "parametrizations.weight.0._u")] = _t(spectral["u"])
        sd[_key(prefix, "parametrizations.weight.0._v")] = _t(spectral["v"])
    else:
        sd[_key(prefix, "weight")] = _t(w)


def conv_state(sd: StateDict, prefix: str, params: Tree,
               spectral: Optional[Tree], transposed: bool = False) -> None:
    w = np.asarray(params["kernel"], np.float32).transpose(
        (3, 4, 0, 1, 2) if transposed else (4, 3, 0, 1, 2))
    _weight(sd, prefix, w, spectral)
    if "bias" in params:
        sd[_key(prefix, "bias")] = _t(params["bias"])


def linear_state(sd: StateDict, prefix: str, params: Tree,
                 spectral: Optional[Tree]) -> None:
    _weight(sd, prefix, np.asarray(params["kernel"], np.float32).T, spectral)
    if "bias" in params:
        sd[_key(prefix, "bias")] = _t(params["bias"])


def bn_state(sd: StateDict, prefix: str, params: Tree, stats: Tree) -> None:
    sd[_key(prefix, "weight")] = _t(params["scale"])
    sd[_key(prefix, "bias")] = _t(params["bias"])
    sd[_key(prefix, "running_mean")] = _t(stats["mean"])
    sd[_key(prefix, "running_var")] = _t(stats["var"])
    sd[_key(prefix, "num_batches_tracked")] = torch.tensor(0, dtype=torch.int64)


def layernorm_state(sd: StateDict, prefix: str, params: Tree) -> None:
    for name, key in (("scale", "weight"), ("bias", "bias")):
        sd[_key(prefix, key)] = _t(np.asarray(params[name], np.float32)
                                   .transpose(3, 0, 1, 2))


def attention_state(sd: StateDict, prefix: str, params: Tree,
                    spectral: Optional[Tree]) -> None:
    spectral = spectral or {}
    for name in ("f", "g", "h", "v"):
        conv_state(sd, _key(prefix, name), params[name], spectral.get(name))
    sd[_key(prefix, "gamma")] = _t(params["gamma"])


def deep_block_state(sd: StateDict, prefix: str, params: Tree,
                     stats: Optional[Tree], spectral: Optional[Tree]) -> None:
    spectral = spectral or {}
    for c in ("conv1", "conv2", "conv3", "conv4", "conv_sc"):
        if c in params:
            conv_state(sd, _key(prefix, c), params[c], spectral.get(c))
    if stats is not None:
        for b in ("bn1", "bn2", "bn3", "bn4"):
            bn_state(sd, _key(prefix, b), params[b], stats[b])


def _has_attention(cfg: Config, arch, idx: int) -> bool:
    return bool((cfg.sagan or cfg.biggan)
                and arch["attention"][arch["resolution"][idx]])


def _generator(params: Tree, stats: Tree, spectral: Tree,
               cfg: Config) -> StateDict:
    sd: StateDict = {}
    linear_state(sd, "linear", params["linear"], spectral.get("linear"))
    arch = cfg.biggan_g_arch()
    t = 0  # index into the port's blocks list
    for idx in range(len(arch["out_channels"])):
        names = [f"g{idx}_0", f"g{idx}_1"] if cfg.biggan else [f"g{idx}_0"]
        for name in names:
            deep_block_state(sd, f"blocks.{t}.0", params[name], stats[name],
                             spectral.get(name))
            t += 1
        if _has_attention(cfg, arch, idx):
            attention_state(sd, f"blocks.{t - 1}.1", params[f"attn{idx}"],
                            spectral.get(f"attn{idx}"))
    bn_state(sd, "output_layer.0", params["out_bn"], stats["out_bn"])
    conv_state(sd, "output_layer.2", params["out_conv"],
               spectral.get("out_conv"))
    return sd


def _discriminator(params: Tree, spectral: Tree, cfg: Config) -> StateDict:
    sd: StateDict = {}
    conv_state(sd, "input_conv", params["input_conv"],
               spectral.get("input_conv"))
    arch = cfg.biggan_d_arch()
    for idx in range(len(arch["out_channels"])):
        names = [f"d{idx}_0", f"d{idx}_1"] if cfg.biggan else [f"d{idx}_0"]
        for j, name in enumerate(names):
            deep_block_state(sd, f"blocks.{idx}.{j}", params[name], None,
                             spectral.get(name))
        if _has_attention(cfg, arch, idx):
            attention_state(sd, f"blocks.{idx}.{len(names)}",
                            params[f"attn{idx}"], spectral.get(f"attn{idx}"))
    linear_state(sd, "linear", params["linear"], spectral.get("linear"))
    return sd


def _dcgan_generator(params: Tree, stats: Tree, spectral: Tree,
                     cfg: Config) -> StateDict:
    """main: [ConvT, BN, ReLU] a stage, SelfAttention3d after the res/4
    stage with sagan, then [ConvT, Tanh] (export.py:115-147)."""
    sd: StateDict = {}
    chans = cfg.dcgan_g_channels()
    i, res = 0, 4
    for stage in range(len(chans)):
        conv_state(sd, f"main.{i}", params[f"ConvTranspose3d_{stage}"], None,
                   transposed=True)
        bn_state(sd, f"main.{i + 1}", params[f"BatchNorm3d_{stage}"],
                 stats[f"BatchNorm3d_{stage}"])
        i += 3
        if stage > 0:
            res *= 2
            if cfg.sagan and res == cfg.resolution // 4:
                attention_state(sd, f"main.{i}", params["SelfAttention3d_0"],
                                spectral.get("SelfAttention3d_0"))
                i += 1
    conv_state(sd, f"main.{i}", params[f"ConvTranspose3d_{len(chans)}"],
               None, transposed=True)
    return sd


def _dcgan_discriminator(params: Tree, spectral: Tree,
                         cfg: Config) -> StateDict:
    """main for the four D variants (export.py:150-187)."""
    sd: StateDict = {}
    chans = cfg.dcgan_d_channels()
    if cfg.msl:
        n = max(1, len(chans) - 1)
        for j in range(n + 1):   # after main.0, the RandomCrop3D
            conv_state(sd, f"main.{1 + 2 * j}", params[f"SNConv3d_{j}"],
                       spectral[f"SNConv3d_{j}"])
    elif cfg.sngan or cfg.sagan:
        i, res = 0, cfg.resolution
        for j in range(len(chans)):
            conv_state(sd, f"main.{i}", params[f"SNConv3d_{j}"],
                       spectral[f"SNConv3d_{j}"])
            i += 2
            res //= 2
            if cfg.sagan and res == 8:
                attention_state(sd, f"main.{i}", params["SelfAttention3d_0"],
                                spectral.get("SelfAttention3d_0"))
                i += 1
        conv_state(sd, f"main.{i}", params[f"SNConv3d_{len(chans)}"],
                   spectral[f"SNConv3d_{len(chans)}"])
    else:
        for j in range(len(chans)):
            conv_state(sd, f"main.{3 * j}", params[f"Conv3d_{j}"], None)
            layernorm_state(sd, f"main.{3 * j + 1}",
                            params[f"LayerNormVolume_{j}"])
        conv_state(sd, f"main.{3 * len(chans)}",
                   params[f"Conv3d_{len(chans)}"], None)
    return sd


def _fc(sd: StateDict, prefix: str, params: Tree) -> None:
    sd[_key(prefix, "weight")] = _t(np.asarray(params["weight"],
                                               np.float32).T)
    if "bias" in params:
        sd[_key(prefix, "bias")] = _t(params["bias"])


def _style_layer(sd: StateDict, prefix: str, params: Tree) -> None:
    """A StyleGAN conv layer's raw weight [k, k, k, I, O] -> [O, I, k, k,
    k], its bias, and its affine FC, if any."""
    sd[_key(prefix, "weight")] = _t(np.asarray(params["weight"], np.float32)
                                    .transpose(4, 3, 0, 1, 2))
    if "bias" in params:
        sd[_key(prefix, "bias")] = _t(params["bias"])
    if "affine" in params:
        _fc(sd, _key(prefix, "affine"), params["affine"])


def _stylegan2_generator(params: Tree, moving: Tree) -> StateDict:
    """mapping.fc{i}, mapping.w_avg; synthesis.b{res} with const / conv0 /
    conv1 / torgb (export.py:273-312)."""
    sd: StateDict = {}
    for fc, p in sorted(params["mapping"].items()):
        _fc(sd, f"mapping.{fc}", p)
    w_avg = moving.get("mapping", {}).get("w_avg")
    sd["mapping.w_avg"] = (_t(w_avg) if w_avg is not None
                           else torch.zeros(512))
    rng = np.random.default_rng(0)
    syn = params["synthesis"]
    for bname in sorted(syn, key=lambda b: int(b[1:])):
        blk, res = syn[bname], int(bname[1:])
        if "const" in blk:
            sd[f"synthesis.{bname}.const"] = _t(
                np.asarray(blk["const"], np.float32).transpose(3, 0, 1, 2))
        for lname in ("conv0", "conv1", "torgb"):
            if lname not in blk:
                continue
            prefix = f"synthesis.{bname}.{lname}"
            _style_layer(sd, prefix, blk[lname])
            if "noise_strength" in blk[lname]:
                sd[f"{prefix}.noise_strength"] = _t(
                    blk[lname]["noise_strength"])
                sd[f"{prefix}.noise_const"] = _t(rng.standard_normal(
                    (res, res)).astype(np.float32))
    return sd


def _stylegan_discriminator(params: Tree) -> StateDict:
    """b{res} resnet blocks (fromrgb, conv0, conv1, skip) and the epilogue
    b4 (conv, fc, out), export.py:315-339."""
    sd: StateDict = {}
    for bname, blk in params.items():
        for lname in ("fromrgb", "conv0", "conv1", "skip", "conv"):
            if lname in blk:
                _style_layer(sd, f"{bname}.{lname}", blk[lname])
        if "fc" in blk:
            w = np.asarray(blk["fc"]["weight"], np.float32)  # [flat, O]
            flat, o = w.shape
            w = (w.reshape(4, 4, 4, flat // 64, o).transpose(3, 0, 1, 2, 4)
                 .reshape(flat, o))
            _fc(sd, f"{bname}.fc", {**blk["fc"], "weight": w})
        if "out" in blk:
            _fc(sd, f"{bname}.out", blk["out"])
    return sd


def from_jax_variables(variables: Tree, cfg: Config, which: str = "g"
                       ) -> StateDict:
    """JAX variable trees (numpy leaves) -> the port's G or D state_dict."""
    fam = cfg.family()
    if fam not in ("biggan", "dcgan", "hybrid", "stylegan2"):
        raise NotImplementedError(
            f"weight conversion for family {fam!r} is not ported yet")
    if which not in ("g", "d"):
        raise ValueError(f"which must be 'g' or 'd', not {which!r}")
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    spectral = variables.get("spectral", {})
    if fam == "stylegan2":
        if which == "g":
            return _stylegan2_generator(params, variables.get("moving", {}))
        return _stylegan_discriminator(params)
    if which == "g":
        if fam == "dcgan":
            return _dcgan_generator(params, stats, spectral, cfg)
        return _generator(params, stats, spectral, cfg)
    if fam == "biggan":
        return _discriminator(params, spectral, cfg)
    return _dcgan_discriminator(params, spectral, cfg)

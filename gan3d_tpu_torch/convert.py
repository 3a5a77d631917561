"""Carry JAX-package weights across: variable trees -> the port's state_dicts.

``from_jax_variables(variables, cfg, which)`` takes the JAX package's
``{"params", "batch_stats", "spectral"}`` trees of one BigGAN network (as
numpy arrays) and returns the state_dict of the port's module of the same
config, which loads with ``strict=True``. The key names and layouts are the
reference's torch ones (the same mapping as gan3d_tpu/eval/export.py:59-104
and 193-252):

- conv kernel [kd, kh, kw, I, O]  -> weight [O, I, kd, kh, kw]
- linear kernel [I, O]            -> weight [O, I]
- spectral {u, v}                 -> ``parametrizations.weight.original``,
                                     ``.0._u``, ``.0._v``
- BN scale/bias + batch_stats     -> weight/bias/running_mean/running_var
                                     (+ num_batches_tracked = 0)
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
               spectral: Optional[Tree]) -> None:
    w = np.asarray(params["kernel"], np.float32).transpose(4, 3, 0, 1, 2)
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


def from_jax_variables(variables: Tree, cfg: Config, which: str = "g"
                       ) -> StateDict:
    """JAX variable trees (numpy leaves) -> the port's G or D state_dict."""
    if cfg.family() != "biggan":
        raise NotImplementedError(
            f"weight conversion for family {cfg.family()!r} is not ported yet")
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    spectral = variables.get("spectral", {})
    if which == "g":
        return _generator(params, stats, spectral, cfg)
    if which == "d":
        return _discriminator(params, spectral, cfg)
    raise ValueError(f"which must be 'g' or 'd', not {which!r}")

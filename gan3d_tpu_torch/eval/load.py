"""Load trained runs for evaluation (counterpart of gan3d_tpu/eval/load.py;
reference eval.py:15-29, tournament.py:14-33).

A run dir holds its config and one checkpoint: the port's own
(``params.json`` + ``models/checkpoint.pt``) or the reference's
(``params.pkl`` + ``models/checkpoint.pt``). Both checkpoints hold the
reference's state_dicts (``modelG_state_dict`` / ``modelD_state_dict``,
``module.`` prefixes stripped), which the port's modules load with
``strict=True``: no conversion.

``make_sampler`` and ``make_discriminator_fn`` run the networks as the
JAX package's do (load.py:66-128): in train mode (BN on batch statistics,
spectral norm stepping), with the state updates thrown away (every call
starts from the checkpoint's buffers), outputs in f32. Their draws come
from a generator seeded 0 on every call: StyleGAN-1's mixing, StyleGAN2's
noise and the msl D's crops, as the JAX package fixes ``key(0)``.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models.registry import build_models
from gan3d_tpu_torch.train.checkpoint import CHECKPOINT_FILE


def check_devices(num_devices: int) -> None:
    """One device only: data-parallel evaluation is slice 8's."""
    n = num_devices if num_devices > 0 else max(torch.cuda.device_count(), 1)
    if n > 1:
        raise NotImplementedError(
            "multi-device evaluation (num_devices > 1) is not ported yet "
            "(ROADMAP.md queue A, slice 8)")


def _strip(sd):
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def load_run(path: str, compute_dtype: Optional[str] = None,
             device: torch.device = torch.device("cpu")
             ) -> Tuple[Config, torch.nn.Module, torch.nn.Module]:
    """(cfg, G, D) of a run dir, weights restored, on ``device`` in train
    mode. ``compute_dtype`` overrides the run's."""
    cfg = Config.load(path)
    if compute_dtype:
        cfg = cfg.replace(compute_dtype=compute_dtype)
    ckpt = os.path.join(path, "models", CHECKPOINT_FILE)
    if not os.path.isfile(ckpt):
        raise FileNotFoundError(f"no checkpoint in {os.path.dirname(ckpt)}")
    payload = torch.load(ckpt, map_location="cpu", weights_only=False)
    G, D = build_models(cfg)
    G.load_state_dict(_strip(payload["modelG_state_dict"]), strict=True)
    D.load_state_dict(_strip(payload["modelD_state_dict"]), strict=True)
    return cfg, G.to(device).train(), D.to(device).train()


def _stateless(net: torch.nn.Module, fn: Callable) -> Callable:
    """``fn`` under no_grad, with ``net``'s buffers (BN statistics, the
    spectral norm's vectors) put back after every call."""
    def call(*args):
        saved = [b.clone() for b in net.buffers()]
        try:
            with torch.no_grad():
                return fn(*args)
        finally:
            with torch.no_grad():
                for b, s in zip(net.buffers(), saved):
                    b.copy_(s)
    return call


def _seed0(device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return g


def make_sampler(cfg: Config, G: torch.nn.Module
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """z [N, z] -> volumes [N, 1, R, R, R] in f32, on G's device."""
    fam = cfg.family()
    device = next(G.parameters()).device

    def sample(z: torch.Tensor) -> torch.Tensor:
        G.train()
        z = z.to(device)
        if fam == "stylegan2":
            out = G(z, generator=_seed0(device))[0]
        elif fam == "stylegan":
            out = G(z, generator=_seed0(device))
        else:
            out = G(z)
        return out.float()

    return _stateless(G, sample)


def make_discriminator_fn(cfg: Config, D: torch.nn.Module
                          ) -> Callable[[torch.Tensor], torch.Tensor]:
    """x [N, 1, R, R, R] -> D(x) [N, 1] in f32, on D's device."""
    device = next(D.parameters()).device

    def score(x: torch.Tensor) -> torch.Tensor:
        D.train()
        x = x.to(device)
        if cfg.msl:
            return D(x, D.draw_offsets(x, _seed0(device))).float()
        return D(x).float()

    return _stateless(D, score)

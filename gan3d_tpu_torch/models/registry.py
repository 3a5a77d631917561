"""Model family selection (reference: trainer.py:52-68).

Precedence, as gan3d_tpu/models/registry.py: hybrid (BigGAN G + DCGAN D)
> dcgan > stylegan2 > stylegan > BigGAN (the sngan / sagan / biggan
variants). StyleGAN-1 raises, naming the ROADMAP slice that ports it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gan3d_tpu_torch.config import Config

_LATER = {"stylegan": "slice 6"}


def build_models(cfg: Config) -> Tuple[torch.nn.Module, torch.nn.Module]:
    """(generator, discriminator) on the CPU, initialized from ``cfg.seed``.

    Initialization (weights and the spectral-norm warm start) draws from a
    generator forked from and seeded by ``cfg.seed``, so it is the same for
    every run with that seed and leaves the global RNG untouched.
    """
    fam = cfg.family()
    if fam in _LATER:
        raise NotImplementedError(
            f"family {fam!r} is not ported yet (ROADMAP.md queue A, "
            f"{_LATER[fam]})")
    if cfg.remat:
        raise NotImplementedError(
            "remat is not ported yet: torch.utils.checkpoint would step the "
            "spectral-norm and BN state twice (ROADMAP.md queue A)")
    from gan3d_tpu_torch.models import biggan, dcgan, stylegan

    if fam == "stylegan2":
        g_cls, d_cls = stylegan.Generator, stylegan.Discriminator
    else:
        g_cls = dcgan.Generator if fam == "dcgan" else biggan.Generator
        d_cls = (biggan.Discriminator if fam == "biggan"
                 else dcgan.Discriminator)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        return g_cls(cfg), d_cls(cfg)

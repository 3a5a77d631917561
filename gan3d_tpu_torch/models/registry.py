"""Model family selection (reference: trainer.py:52-68).

The port builds the BigGAN family (the sngan / sagan / biggan variants);
every other family raises, naming the ROADMAP slice that ports it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gan3d_tpu_torch.config import Config

_LATER = {"dcgan": "slice 2", "hybrid": "slice 2", "stylegan2": "slice 3",
          "stylegan": "slice 4"}


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
    from gan3d_tpu_torch.models import biggan

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        return biggan.Generator(cfg), biggan.Discriminator(cfg)

"""Model family selection (reference: trainer.py:52-68).

Precedence, as gan3d_tpu/models/registry.py: hybrid (BigGAN G + DCGAN D)
> dcgan > stylegan2 > stylegan > BigGAN (the sngan / sagan / biggan
variants). StyleGAN-1 pairs its AdaIN G with StyleGAN2's D
(gan3d_tpu/models/registry.py:51-55).

In a data-parallel run (``replicas``, parallel/dist.py) every module that
sees the batch as a whole learns its rank's place: BatchNorm takes the
global batch's statistics (``cfg.sync_bn``), or with ``sync_bn=False``
each rank's own, the per-replica statistics the JAX package expresses as
batch groups (gan3d_tpu/models/registry.py:20-28), with the running-stat
updates averaged over ranks; the minibatch-std layer, StyleGAN-1's
mixing, the synthesis noise and the msl crops span the global batch.

``cfg.remat`` recomputes activations in backward (nn/remat.py) in the
BigGAN G and D (the hybrid's G too), StyleGAN2's synthesis blocks and the
StyleGAN D's blocks, where the JAX package does; the DCGAN G and D and
StyleGAN-1's G have none there (gan3d_tpu/models/dcgan.py never reads
``cfg.remat``), so the flag changes nothing for them.

Under a model axis (``replicas.model`` > 1) each network, built whole
from the seed, keeps this rank's slices of the parameters the rule
shards (parallel/tp.py ``shard``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.parallel.dist import Replicas, attach


def build_models(cfg: Config, replicas: Optional[Replicas] = None
                 ) -> Tuple[torch.nn.Module, torch.nn.Module]:
    """(generator, discriminator) on the CPU, initialized from ``cfg.seed``
    (the same on every rank), with ``replicas`` attached when given.

    Initialization (weights and the spectral-norm warm start) draws from a
    generator forked from and seeded by ``cfg.seed``, so it is the same for
    every run with that seed and leaves the global RNG untouched.
    """
    fam = cfg.family()
    from gan3d_tpu_torch.models import biggan, dcgan, stylegan
    from gan3d_tpu_torch.nn import remat

    remat.scope(cfg.remat, cfg.remat_scope)  # raises on an unknown scope

    if fam == "stylegan2":
        g_cls, d_cls = stylegan.Generator, stylegan.Discriminator
    elif fam == "stylegan":
        g_cls, d_cls = stylegan.StyleGAN1Generator, stylegan.Discriminator
    else:
        g_cls = dcgan.Generator if fam == "dcgan" else biggan.Generator
        d_cls = (biggan.Discriminator if fam == "biggan"
                 else dcgan.Discriminator)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        G, D = g_cls(cfg), d_cls(cfg)
    if replicas is not None:
        from gan3d_tpu_torch.nn.norm import BatchNorm3d

        for net in (G, D):
            attach(net, replicas)
            for m in net.modules():
                if isinstance(m, BatchNorm3d):
                    m.sync = cfg.sync_bn
        if replicas.model > 1:
            from gan3d_tpu_torch.parallel import tp

            tp.shard(G, replicas)
            tp.shard(D, replicas)
    return G, D

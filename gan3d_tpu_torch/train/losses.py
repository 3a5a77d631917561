"""GAN losses (counterpart of gan3d_tpu/train/losses.py).

- hinge D loss: ReLU(1 - D(x)).mean() + ReLU(1 + D(G(z))).mean()
  (reference trainer.py:228-230); G loss -D(G(z)).mean() for hinge and
  WGAN (trainer.py:272);
- WGAN D loss: D(G(z)).mean() - D(x).mean() (trainer.py:240-243), with the
  opt-in gradient penalty. The penalty differentiates D twice, which the
  attention kernels' first-order backward refuses: on the card the trainer
  takes it only for a D without attention (the WGAN-LN and msl DCGAN Ds,
  the hybrid's). Under a space axis (parallel/sp.py) the penalty's
  per-sample squared norm is a slab's part, summed over the space group.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from gan3d_tpu_torch.parallel import sp


def d_hinge(d_real: torch.Tensor, d_fake: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (errD_real, errD_fake) per the reference's bookkeeping."""
    return F.relu(1.0 - d_real).mean(), F.relu(1.0 + d_fake).mean()


def d_wgan(d_real: torch.Tensor, d_fake: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two means the reference logs; errD = fake - real."""
    return d_real.mean(), d_fake.mean()


def g_adversarial(d_fake: torch.Tensor) -> torch.Tensor:
    return -d_fake.mean()


def gradient_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor, weight: float,
                     alpha: torch.Tensor, replicas=None) -> torch.Tensor:
    """WGAN-GP: ((||grad_x D(x_interp)|| - 1)^2).mean() * weight, x_interp
    = alpha real + (1 - alpha) fake with alpha [B, 1, 1, 1, 1] (the train
    step draws it); on depth slabs (``replicas`` with a space axis) the
    squared norm's parts summed over space."""
    alpha = alpha.to(real.device, real.dtype)
    interp = (alpha * real + (1.0 - alpha) * fake).requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(interp).sum(), interp,
                                   create_graph=True)
    g = grads.reshape(grads.shape[0], -1).float()
    sq = torch.sum(g * g, dim=1)
    if sp.on(replicas) and sp.is_sharded(interp):
        sq = sp.reduce(sq, replicas)
    norms = torch.sqrt(sq + 1e-12)
    return torch.mean((norms - 1.0) ** 2) * weight

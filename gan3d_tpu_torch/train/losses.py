"""GAN losses (counterpart of gan3d_tpu/train/losses.py).

- hinge D loss: ReLU(1 - D(x)).mean() + ReLU(1 + D(G(z))).mean()
  (reference trainer.py:228-230); G loss -D(G(z)).mean() for hinge and
  WGAN (trainer.py:272);
- WGAN D loss: D(G(z)).mean() - D(x).mean() (trainer.py:240-243), with the
  opt-in gradient penalty. The penalty differentiates D twice, which the
  attention kernels' first-order backward refuses: on the card it runs only
  for models without attention.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


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
                     real: torch.Tensor, fake: torch.Tensor,
                     weight: float = 10.0,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """WGAN-GP: ((||grad_x D(x_interp)|| - 1)^2).mean() * weight."""
    alpha = torch.rand((real.shape[0], 1, 1, 1, 1), dtype=real.dtype,
                       device=real.device, generator=generator)
    interp = (alpha * real + (1.0 - alpha) * fake).requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(interp).sum(), interp,
                                   create_graph=True)
    g = grads.reshape(grads.shape[0], -1).float()
    norms = torch.sqrt(torch.sum(g * g, dim=1) + 1e-12)
    return torch.mean((norms - 1.0) ** 2) * weight

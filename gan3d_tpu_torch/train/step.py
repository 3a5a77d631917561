"""The fused train step: iterD D-updates + 1 G-update per call.

Counterpart of gan3d_tpu/train/step.py:47-142, in the same order:

for each of the iterD D iterations:
  1. fresh noise;
  2. G forward in train mode under no_grad — G's BN running stats and SN
     vectors update;
  3. D(real), then D(fake), as two forwards — D's SN vectors step twice per
     D update, and D(fake) uses the vectors D(real) left;
  4. Adam on D.
then one G update: G forward, D forward (D's parameters are not updated
but its SN vectors step), gradients of G's parameters only, Adam on G.
D's parameters are frozen (requires_grad off) for the G update, so its
backward computes no weight gradient for D: the custom autograd Functions
of the conv kernels would otherwise run their dW kernel for nothing.

Noise comes from ``noises`` when given (iterD + 1 tensors [B, z], so a test
can inject the JAX package's draws), else from ``generator``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.train import losses
from gan3d_tpu_torch.train.state import Adam


@contextlib.contextmanager
def _frozen(net: torch.nn.Module) -> Iterator[None]:
    params = [p for p in net.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def train_step(cfg: Config, G: torch.nn.Module, D: torch.nn.Module,
               g_opt: Adam, d_opt: Adam, reals: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               noises: Optional[Sequence[torch.Tensor]] = None
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One fused step. ``reals`` is [iterD, B, 1, R, R, R] on the device.

    Returns ({"d_real", "d_fake", "g_loss"} as 0-d tensors, the G-step's
    fake batch, detached).
    """
    b = reals.shape[1]
    dev = reals.device

    def noise(i: int) -> torch.Tensor:
        if noises is not None:
            return noises[i].to(dev, torch.float32)
        return torch.randn((b, cfg.z_size), generator=generator, device=dev)

    err_real = err_fake = torch.zeros((), device=dev)
    for i in range(cfg.iterD):
        real = reals[i]
        with torch.no_grad():
            fake = G(noise(i)).to(real.dtype)
        d_real = D(real).float()
        d_fake = D(fake).float()
        if cfg.hinge:
            err_real, err_fake = losses.d_hinge(d_real, d_fake)
            err = err_real + err_fake
        else:
            err_real, err_fake = losses.d_wgan(d_real, d_fake)
            err = err_fake - err_real
            if cfg.gp_weight > 0:
                err = err + losses.gradient_penalty(
                    lambda x: D(x).float(), real, fake, cfg.gp_weight,
                    generator=generator)
        d_opt.step(torch.autograd.grad(err, d_opt.params))
        err_real, err_fake = err_real.detach(), err_fake.detach()

    fake = G(noise(cfg.iterD))
    with _frozen(D):
        err_g = losses.g_adversarial(D(fake).float())
        g_opt.step(torch.autograd.grad(err_g, g_opt.params))
    return ({"d_real": err_real, "d_fake": err_fake,
             "g_loss": err_g.detach()}, fake.detach())

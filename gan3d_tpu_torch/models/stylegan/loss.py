"""StyleGAN2 and StyleGAN-1 loss and fused train step.

Counterpart of gan3d_tpu/models/stylegan/loss.py (reference stylegan.py
:6-99, trainer.py:214-220, 262-269), in its order: iterD D updates, then
one G update, then the EMA fold-back.

- non-saturating softplus losses in f32: D minimizes softplus(D(fake)) +
  softplus(-D(real)), G softplus(-D(fake));
- style mixing with probability 0.9: a cutoff in [1, num_ws) takes the
  tail ws from a second mapping of a fresh z (loss.py:77-90);
- lazy R1 on the reals, gamma 10, on steps with step % 16 == 0
  (loss.py:95-128), with the reference's axis quirk: the squared gradient
  is summed over NCDHW dims (1, 2, 3) = (C, D, H), not W, and the [N, W]
  penalty is broadcast against the [N, 1] logits term before the mean;
- path-length regularization on the same steps (loss.py:154-187): half
  the batch, pl_noise / sqrt(D * H) (the reference's 2-D heritage), decay
  0.01, weight 2; ``pl_mean`` is carried between steps;
- ``cfg.sg2_reg_grads=False`` (the reference's create_graph=False): both
  penalties enter the logged losses as values only. True: they contribute
  gradients through a double backward (R1 to D, PL to G);
- after the G update, ``ema = params = d * ema + (1 - d) * params`` with d
  = cfg.ema_decay (loss.py:212-217).

Both D updates and the G update of one call read the same ``step``; the
lazy branch is chosen on the host (gan3d_tpu/train/trainer.py:227-259).
Every random draw goes through ``Draws``, in the JAX step's order: each D
update draws z, then G's mixing cutoff, its coin, the mixing z and the
synthesis noise; the G update the same, then (on a lazy step) the PL
synthesis noise and pl_noise.

StyleGAN-1 (``cfg.stylegan``, the JAX loss's v1 branch, loss.py:63-146)
runs the same losses with R1 on every D update, no path-length penalty and
no EMA; ``pl_mean`` passes through unchanged. Its G forward draws only its
own mixing (a swap point, then a permutation: models/stylegan/
stylegan1.py), so each update draws z, the swap point and the permutation.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.train.state import Adam
from gan3d_tpu_torch.train.step import frozen

STYLE_MIXING_PROB = 0.9
R1_GAMMA = 10.0
PL_BATCH_SHRINK = 2
PL_DECAY = 0.01
PL_WEIGHT = 2.0
LAZY_INTERVAL = 16


class Draws:
    """The step's random draws: from ``generator`` on ``device``, or, with
    ``replay``, the given tensors in order (a test feeds the JAX step's
    draws, each checked against the shape asked for)."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 replay: Optional[Iterable[torch.Tensor]] = None):
        self.device, self.generator = device, generator
        self._replay = None if replay is None else iter(replay)

    def _next(self, shape) -> torch.Tensor:
        t = next(self._replay)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"replayed draw of shape {tuple(t.shape)} where "
                             f"{tuple(shape)} is drawn")
        return t.to(self.device)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        if self._replay is not None:
            return self._next(shape).float()
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def randint(self, low: int, high: int) -> torch.Tensor:
        if self._replay is not None:
            return self._next(()).long()
        return torch.randint(low, high, (), generator=self.generator,
                             device=self.device)

    def uniform(self) -> torch.Tensor:
        if self._replay is not None:
            return self._next(()).float()
        return torch.rand((), generator=self.generator, device=self.device)

    def permutation(self, n: int) -> torch.Tensor:
        if self._replay is not None:
            return self._next((n,)).long()
        return torch.randperm(n, generator=self.generator, device=self.device)


def run_generator(G: torch.nn.Module, z: torch.Tensor,
                  draws: Draws) -> torch.Tensor:
    """G forward with style mixing; the image in f32."""
    ws = G.map_ws(z)
    num_ws = ws.shape[1]
    cutoff = draws.randint(1, num_ws)
    cutoff = torch.where(draws.uniform() < STYLE_MIXING_PROB, cutoff, num_ws)
    ws2 = G.map_ws(draws.normal(z.shape))
    idx = torch.arange(num_ws, device=ws.device)[None, :, None]
    ws = torch.where(idx >= cutoff, ws2, ws)
    noise = [draws.normal(s) for s in G.synthesis.noise_shapes(z.shape[0])]
    return G.synthesize(ws, noise)


def r1_penalty(D: torch.nn.Module, real: torch.Tensor, create_graph: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(D(real) in f32, the R1 penalty [N, W]): the squared input gradient
    summed over (C, D, H), times gamma / 2. The logits' graph is kept for
    the D loss's backward."""
    real = real.detach().requires_grad_(True)
    logits = D(real).float()
    (grad,) = torch.autograd.grad(logits.sum(), real, retain_graph=True,
                                  create_graph=create_graph)
    g = grad.float()
    return logits, (g * g).sum(dim=(1, 2, 3)) * (R1_GAMMA / 2)


def path_length_penalty(G: torch.nn.Module, z: torch.Tensor,
                        pl_mean: torch.Tensor, draws: Draws,
                        create_graph: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the PL penalty, the new pl_mean, detached)."""
    ws = G.map_ws(z)
    if not create_graph:
        ws = ws.detach().requires_grad_(True)
    noise = [draws.normal(s) for s in G.synthesis.noise_shapes(z.shape[0])]
    img = G.synthesize(ws, noise)
    pl_noise = draws.normal(img.shape) / math.sqrt(img.shape[2]
                                                   * img.shape[3])
    (grad,) = torch.autograd.grad((img.float() * pl_noise).sum(), ws,
                                  create_graph=create_graph)
    g = grad.float()
    lengths = torch.sqrt((g * g).sum(dim=2).mean(dim=1))
    new_mean = pl_mean + PL_DECAY * (lengths.mean() - pl_mean)
    pen = torch.mean((lengths - new_mean) ** 2) * PL_WEIGHT
    return pen, new_mean.detach()


def train_step(cfg: Config, G: torch.nn.Module, D: torch.nn.Module,
               g_opt: Adam, d_opt: Adam, reals: torch.Tensor, step: int,
               ema: List[torch.Tensor], pl_mean: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Draws] = None
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                          torch.Tensor]:
    """One fused StyleGAN2 or StyleGAN-1 step at ``step``. ``reals`` is
    [iterD, B, 1, R, R, R]; ``ema`` (aligned with ``g_opt.params``) is
    updated in place. Draws come from ``draws`` when given, else from
    ``generator``.

    Returns ({"d_real", "d_fake", "g_loss"} as 0-d tensors, the G update's
    image, detached, and the new pl_mean). StyleGAN-1 (``cfg.family()`` ==
    "stylegan") takes an empty ``ema``.
    """
    b = reals.shape[1]
    draws = draws or Draws(reals.device, generator)
    v2 = cfg.family() == "stylegan2"
    lazy = step % LAZY_INTERVAL == 0
    r1, pl = (lazy, lazy) if v2 else (True, False)
    reg_grads = cfg.sg2_reg_grads

    def generate(z: torch.Tensor) -> torch.Tensor:
        return run_generator(G, z, draws) if v2 else G(z, draws=draws)

    err_real = err_fake = torch.zeros((), device=reals.device)
    for i in range(cfg.iterD):
        real = reals[i]
        z = draws.normal((b, cfg.z_size))
        with torch.no_grad():
            fake = generate(z).to(real.dtype)
        err_fake = F.softplus(D(fake).float()).mean()
        if r1:
            real_logits, pen = r1_penalty(D, real, reg_grads)
            if not reg_grads:
                pen = pen.detach()
            err_real = torch.mean(F.softplus(-real_logits) + pen)
        else:
            err_real = F.softplus(-D(real).float()).mean()
        d_opt.step(torch.autograd.grad(err_fake + err_real, d_opt.params))
        err_real, err_fake = err_real.detach(), err_fake.detach()

    z = draws.normal((b, cfg.z_size))
    with frozen(D):
        img = generate(z)
        err_g = F.softplus(-D(img).float()).mean()
        if pl:
            pen, pl_mean = path_length_penalty(
                G, z[:b // PL_BATCH_SHRINK], pl_mean, draws, reg_grads)
            err_g = err_g + (pen if reg_grads else pen.detach())
        g_opt.step(torch.autograd.grad(err_g, g_opt.params))
    if v2:
        d = cfg.ema_decay
        with torch.no_grad():
            for p, e in zip(g_opt.params, ema):
                e.copy_(d * e + (1 - d) * p)
                p.copy_(e)
    return ({"d_real": err_real, "d_fake": err_fake,
             "g_loss": err_g.detach()}, img.detach(), pl_mean)

"""StyleGAN2 and StyleGAN-1 loss and train step.

Counterpart of gan3d_tpu/models/stylegan/loss.py (reference stylegan.py
:6-99, trainer.py:214-220, 262-269), in its order: iterD D updates, then
one G update, then the EMA fold-back. ``d_step`` is one D update and
``g_step`` the G update with the EMA (the halves of the JAX split steps,
loss.py:269); ``train_step`` is iterD calls of the one and one of the
other, with one ``Draws``, whatever ``cfg.fused_step`` says.

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

Data parallelism (``replicas``, parallel/dist.py; gan3d_tpu/models/
stylegan/loss.py:150-175 under SPMD): every rank makes the same draws,
each of the global batch's shape, and keeps its rows; the mixing cutoff
is one for the global batch. The path-length pass takes the global rows
[0, B // 2), wherever they lie (at 2 ranks all on rank 0), and
``pl_mean`` moves by the global mean of their lengths; its gradient
(``sg2_reg_grads``) is the global penalty's, through a per-rank surrogate
whose derivative is that penalty's, so no collective runs in backward.
Gradients are mean-all-reduced before Adam and the logged losses are the
global batch's, as in train/step.py; under a model axis the rows, draws
and path-length rows are a data rank's, shared by its model group.

Under a space axis (parallel/sp.py) the rows, draws and path-length rows
are a data rank's too, shared by its space group; G writes this rank's
depth slab and D's logits are whole. Each synthesis layer slices its
whole noise draw, and the path-length pass its pl_noise, to the slab.
R1's squared norm is a per-slab part, summed over space (``sp.reduce``).
The path-length gradient with respect to the whole ws is whole as it
comes out: every layer on a slab reads ws through ``tp.copy`` over the
space group (models/stylegan/layers.py), whose backward sums the slabs'
parts. The gradients are made whole over the space group
(``train/step.reduce_grads``) before the data group's mean.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.parallel import sp
from gan3d_tpu_torch.parallel.dist import ONE, Replicas
from gan3d_tpu_torch.train.state import Adam
from gan3d_tpu_torch.train.step import frozen, global_metrics, reduce_grads

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


def run_generator(G: torch.nn.Module, z: torch.Tensor, draws: Draws,
                  replicas: Replicas = ONE) -> torch.Tensor:
    """G forward with style mixing on ``z`` (the rank's rows); the image
    in f32."""
    ws = G.map_ws(z)
    num_ws = ws.shape[1]
    cutoff = draws.randint(1, num_ws)
    cutoff = torch.where(draws.uniform() < STYLE_MIXING_PROB, cutoff, num_ws)
    n = z.shape[0] * replicas.data_world
    ws2 = G.map_ws(replicas.rows(draws.normal((n,) + tuple(z.shape[1:]))))
    idx = torch.arange(num_ws, device=ws.device)[None, :, None]
    ws = torch.where(idx >= cutoff, ws2, ws)
    noise = [replicas.rows(draws.normal(s))
             for s in G.synthesis.noise_shapes(n)]
    return G.synthesize(ws, noise)


def r1_penalty(D: torch.nn.Module, real: torch.Tensor, create_graph: bool,
               replicas: Replicas = ONE
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(D(real) in f32, the R1 penalty [N, W]): the squared input gradient
    summed over (C, D, H), times gamma / 2 (a depth slab's sum summed over
    space). The logits' graph is kept for the D loss's backward."""
    real = real.detach().requires_grad_(True)
    logits = D(real).float()
    (grad,) = torch.autograd.grad(logits.sum(), real, retain_graph=True,
                                  create_graph=create_graph)
    g = grad.float()
    sq = (g * g).sum(dim=(1, 2, 3))
    if sp.on(replicas) and sp.is_sharded(real):
        sq = sp.reduce(sq, replicas)
    return logits, sq * (R1_GAMMA / 2)


def path_length_penalty(G: torch.nn.Module, z: torch.Tensor,
                        pl_mean: torch.Tensor, draws: Draws,
                        create_graph: bool, replicas: Replicas = ONE,
                        n: Optional[int] = None, first: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the PL penalty, the new pl_mean, detached) of rows [first, first +
    len(z)) of the global PL batch of ``n`` (default len(z)). Every rank
    draws the global PL batch's noise; a rank that holds none of its rows
    runs no pass. With S the global sum of the lengths, m = pl_mean + d
    (S / n - pl_mean) and J = w / n * sum (len - m)^2, the value is J on
    every rank; with ``create_graph`` the rank adds a term whose gradient
    is world times its rows' share of J's: dJ/dlen_i = 2w/n (len_i - m) +
    c, c = dJ/dm d / n with dJ/dm = -2w/n (S - n m), a number that all
    ranks hold."""
    k = z.shape[0]
    n = k if n is None else n
    r = G.synthesis.block_resolutions[-1]
    noise = [t[first:first + k] for t in
             (draws.normal(s) for s in G.synthesis.noise_shapes(n))]
    pl_noise = draws.normal((n, 1, r, r, r))[first:first + k] / math.sqrt(
        r * r)
    lengths = torch.zeros((0,), device=pl_mean.device)
    if k:
        ws = G.map_ws(z)
        if not create_graph:
            ws = ws.detach().requires_grad_(True)
        img = G.synthesize(ws, noise)
        if sp.on(replicas) and sp.is_sharded(img):
            pl_noise = pl_noise[:, :, slice(*sp.span(r, replicas))]
        (grad,) = torch.autograd.grad((img.float() * pl_noise).sum(), ws,
                                      create_graph=create_graph)
        g = grad.float()
        lengths = torch.sqrt((g * g).sum(dim=2).mean(dim=1))
    total = replicas.sum(lengths.detach().sum().reshape(1))[0]
    new_mean = pl_mean + PL_DECAY * (total / n - pl_mean)
    dev = lengths - new_mean
    sq = replicas.sum((dev.detach() ** 2).sum().reshape(1))[0]
    pen = sq / n * PL_WEIGHT
    if create_graph and k:
        c = -2 * PL_WEIGHT / n * (total - n * new_mean) * PL_DECAY / n
        part = replicas.data_world * (PL_WEIGHT / n * (dev ** 2).sum()
                                 + c * lengths.sum())
        pen = pen + (part - part.detach())
    return pen, new_mean.detach()


def _flags(cfg: Config, step: int) -> Tuple[bool, bool, bool]:
    """(StyleGAN2, R1 on this step, PL on this step): StyleGAN2's lazy
    branch on step % 16 == 0, StyleGAN-1's R1 on every step."""
    v2 = cfg.family() == "stylegan2"
    lazy = step % LAZY_INTERVAL == 0
    r1, pl = (lazy, lazy) if v2 else (True, False)
    return v2, r1, pl


def _generate(G: torch.nn.Module, z: torch.Tensor, draws: Draws,
              v2: bool, replicas: Replicas = ONE) -> torch.Tensor:
    return (run_generator(G, z, draws, replicas) if v2
            else G(z, draws=draws))


def d_step(cfg: Config, G: torch.nn.Module, D: torch.nn.Module,
           d_opt: Adam, real: torch.Tensor, step: int, draws: Draws,
           replicas: Replicas = ONE) -> Tuple[torch.Tensor, torch.Tensor]:
    """One D update on ``real`` [B, 1, R, R, R] (the rank's rows) at
    ``step``; returns (err_real, err_fake) of those rows, detached."""
    v2, r1, _ = _flags(cfg, step)
    reg_grads = cfg.sg2_reg_grads
    z = replicas.rows(draws.normal((real.shape[0] * replicas.data_world,
                                    cfg.z_size)))
    with torch.no_grad():
        fake = _generate(G, z, draws, v2, replicas).to(real.dtype)
    err_fake = F.softplus(D(fake).float()).mean()
    if r1:
        real_logits, pen = r1_penalty(D, real, reg_grads, replicas)
        if not reg_grads:
            pen = pen.detach()
        err_real = torch.mean(F.softplus(-real_logits) + pen)
    else:
        err_real = F.softplus(-D(real).float()).mean()
    d_opt.step(reduce_grads(replicas, d_opt.params, torch.autograd.grad(
        err_fake + err_real, d_opt.params)))
    return err_real.detach(), err_fake.detach()


def g_step(cfg: Config, G: torch.nn.Module, D: torch.nn.Module,
           g_opt: Adam, b: int, step: int, ema: List[torch.Tensor],
           pl_mean: torch.Tensor, draws: Draws, replicas: Replicas = ONE
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The G update at batch ``b`` (a rank's rows) and ``step``, then
    StyleGAN2's EMA fold-back (``ema`` updated in place); returns (err_g
    and the image rows, detached, and the new pl_mean)."""
    v2, _, pl = _flags(cfg, step)
    reg_grads = cfg.sg2_reg_grads
    n = b * replicas.data_world
    z = replicas.rows(draws.normal((n, cfg.z_size)))
    with frozen(D):
        img = _generate(G, z, draws, v2, replicas)
        err_g = F.softplus(-D(img).float()).mean()
        if pl:
            # the global rows [0, n // 2): this rank's share of them
            n_pl = n // PL_BATCH_SHRINK
            first = replicas.span(n)[0]
            k = min(max(n_pl - first, 0), b)
            pen, pl_mean = path_length_penalty(
                G, z[:k], pl_mean, draws, reg_grads, replicas, n_pl, first)
            err_g = err_g + (pen if reg_grads else pen.detach())
        g_opt.step(reduce_grads(replicas, g_opt.params,
                                torch.autograd.grad(err_g, g_opt.params)))
    if v2:
        d = cfg.ema_decay
        with torch.no_grad():
            for p, e in zip(g_opt.params, ema):
                e.copy_(d * e + (1 - d) * p)
                p.copy_(e)
    return err_g.detach(), img.detach(), pl_mean


def train_step(cfg: Config, G: torch.nn.Module, D: torch.nn.Module,
               g_opt: Adam, d_opt: Adam, reals: torch.Tensor, step: int,
               ema: List[torch.Tensor], pl_mean: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Draws] = None, replicas: Replicas = ONE
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                          torch.Tensor]:
    """One fused StyleGAN2 or StyleGAN-1 step at ``step``. ``reals`` is
    [iterD, B, 1, R, R, R]; ``ema`` (aligned with ``g_opt.params``) is
    updated in place. Draws come from ``draws`` when given, else from
    ``generator``.

    Returns ({"d_real", "d_fake", "g_loss"} as 0-d tensors, the global
    batch's, the G update's image rows, detached, and the new pl_mean).
    StyleGAN-1 (``cfg.family()`` == "stylegan") takes an empty ``ema``.
    """
    draws = draws or Draws(reals.device, generator)
    err_real = err_fake = torch.zeros((), device=reals.device)
    for i in range(cfg.iterD):
        err_real, err_fake = d_step(cfg, G, D, d_opt, reals[i], step, draws,
                                    replicas)
    err_g, img, pl_mean = g_step(cfg, G, D, g_opt, reals.shape[1], step, ema,
                                 pl_mean, draws, replicas)
    return (global_metrics(replicas, err_real, err_fake, err_g), img,
            pl_mean)

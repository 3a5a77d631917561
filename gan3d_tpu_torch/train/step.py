"""The train step: iterD D-updates + 1 G-update.

Counterpart of gan3d_tpu/train/step.py:47-167. ``d_step`` is one D update
and ``g_step`` the G update (the JAX ``d_update`` / ``g_phase``, which
its split steps, ``build_split_steps``, run as separate programs);
``train_step`` is iterD calls of the one and one of the other, whatever
``cfg.fused_step`` says. The order, as in the JAX step:

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
can inject the JAX package's draws; ``noise`` of one update), else from
``generator``.

The msl DCGAN D crops its input at random offsets (nn/msl.py). As in the
JAX step (step.py:57, 67-69, 81, 105), each D forward draws its own
offsets, all from ``generator`` (never from the global RNG): D(real),
D(fake), the G update's D(fake); the gradient penalty's D forward reuses
D(real)'s offsets.

The gradient penalty's D forward is, as in the JAX step (step.py:79-81),
D applied from the spectral-norm state the D update started from (so it
steps the power iteration as D(real) did and sees D(real)'s sigma),
with what it writes to that state discarded: D's SN vectors step twice
per D update with or without the penalty. Its interpolation weights come
from ``alphas`` when given (iterD tensors [B, 1, 1, 1, 1]; ``alpha`` of
one update), else from ``generator``.

Data parallelism (``replicas``, parallel/dist.py; the JAX step's SPMD
gradient psum, gan3d_tpu/train/step.py:7): ``real`` is the rank's rows of
the global batch. Every rank draws the global batch's noise, penalty
weights and crop offsets from the same generator and keeps its rows
(given ``noises`` and ``alphas`` are global too), each update's gradients
are mean-all-reduced (one flat buffer a network) before Adam, and the
logged losses are the global batch's. The one-process run (``ONE``) is
the step above, unchanged. Under a model axis (``model_devices``,
parallel/tp.py) the ranks of a model group take the same rows and draws;
``tp.reduce_grads`` makes the replicated leaves' gradients whole and
alike over the model group before the data group's mean, and Adam steps
each rank's shards. Under a space axis (``spatial_devices``,
parallel/sp.py) ``real`` is the rank's rows and its depth slab ([B, 1,
R/S, R, R]), G writes the same slab of its fake, D's outputs and so the
losses are computed alike on the ranks of a space group, the gradient
penalty's per-sample norm sums its squares over space, and
``sp.reduce_grads`` makes the gradients whole and alike over the space
group before the data group's mean.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.parallel import sp, tp
from gan3d_tpu_torch.parallel.dist import ONE, Replicas
from gan3d_tpu_torch.train import losses
from gan3d_tpu_torch.train.state import Adam


@contextlib.contextmanager
def frozen(net: torch.nn.Module) -> Iterator[None]:
    """``net``'s parameters with requires_grad off inside the block."""
    params = [p for p in net.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _noise(cfg: Config, b: int, dev: torch.device,
           generator: Optional[torch.Generator],
           noise: Optional[torch.Tensor],
           replicas: Replicas = ONE) -> torch.Tensor:
    """The rank's rows of the global batch's noise (``b`` rows a rank)."""
    if noise is None:
        noise = torch.randn((b * replicas.data_world, cfg.z_size),
                            generator=generator, device=dev)
    return replicas.rows(noise.to(dev, torch.float32))


def _d_out(D: torch.nn.Module, x: torch.Tensor,
           generator: Optional[torch.Generator],
           offsets: Optional[torch.Tensor] = None,
           state: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """D(x) in f32; the msl D crops at ``offsets``, else at offsets drawn
    from ``generator``. With ``state`` D runs on those tensors as its SN
    vectors, so the power iteration writes there and D's own buffers are
    not touched."""
    args = (x,)
    if getattr(D, "msl", False):
        args += (D.draw_offsets(x, generator) if offsets is None
                 else offsets,)
    if state is None:
        return D(*args).float()
    return functional_call(D, state, args).float()


def reduce_grads(replicas: Replicas, params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """The gradients Adam applies: made whole over the space group
    (``sp.reduce_grads``) or the model group, then averaged over the data
    group (``tp.reduce_grads``)."""
    return tp.reduce_grads(replicas, params,
                           sp.reduce_grads(replicas, params, grads))


def d_step(cfg: Config, G: torch.nn.Module, D: torch.nn.Module,
           d_opt: Adam, real: torch.Tensor,
           generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None,
           alpha: Optional[torch.Tensor] = None,
           replicas: Replicas = ONE) -> Tuple[torch.Tensor, torch.Tensor]:
    """One D update on ``real`` [B, 1, R, R, R] (the rank's rows); returns
    (err_real, err_fake) of those rows, detached."""
    with torch.no_grad():
        fake = G(_noise(cfg, real.shape[0], real.device, generator,
                        noise, replicas)).to(real.dtype)
    # D's spectral-norm vectors as the update found them, for the
    # penalty's forward
    start = ({name: buf.clone() for name, buf in D.named_buffers()
              if name.endswith(("._u", "._v"))} if cfg.gp_weight > 0 else {})
    crops = (D.draw_offsets(real, generator) if getattr(D, "msl", False)
             else None)
    d_real = _d_out(D, real, generator, crops)
    d_fake = _d_out(D, fake, generator)
    if cfg.hinge:
        err_real, err_fake = losses.d_hinge(d_real, d_fake)
        err = err_real + err_fake
    else:
        err_real, err_fake = losses.d_wgan(d_real, d_fake)
        err = err_fake - err_real
        if cfg.gp_weight > 0:
            if alpha is None:  # the global batch's
                alpha = torch.rand(
                    (real.shape[0] * replicas.data_world, 1, 1, 1, 1),
                    dtype=real.dtype, device=real.device, generator=generator)
            err = err + losses.gradient_penalty(
                lambda x: _d_out(D, x, generator, crops, start), real, fake,
                cfg.gp_weight, alpha=replicas.rows(alpha.to(real.device)),
                replicas=replicas)
    d_opt.step(reduce_grads(replicas, d_opt.params,
                            torch.autograd.grad(err, d_opt.params)))
    return err_real.detach(), err_fake.detach()


def g_step(cfg: Config, G: torch.nn.Module, D: torch.nn.Module,
           g_opt: Adam, b: int, device: torch.device,
           generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None,
           replicas: Replicas = ONE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The G update at batch ``b`` (a rank's rows); returns (err_g, the
    fake rows), both detached."""
    fake = G(_noise(cfg, b, device, generator, noise, replicas))
    with frozen(D):
        err_g = losses.g_adversarial(_d_out(D, fake, generator))
        g_opt.step(reduce_grads(replicas, g_opt.params,
                                torch.autograd.grad(err_g, g_opt.params)))
    return err_g.detach(), fake.detach()


def train_step(cfg: Config, G: torch.nn.Module, D: torch.nn.Module,
               g_opt: Adam, d_opt: Adam, reals: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               noises: Optional[Sequence[torch.Tensor]] = None,
               alphas: Optional[Sequence[torch.Tensor]] = None,
               replicas: Replicas = ONE
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One fused step. ``reals`` is [iterD, B, 1, R, R, R] on the device
    (the rank's rows of the global batch).

    Returns ({"d_real", "d_fake", "g_loss"} as 0-d tensors, the global
    batch's, and the G-step's fake rows, detached).
    """
    err_real = err_fake = torch.zeros((), device=reals.device)
    for i in range(cfg.iterD):
        err_real, err_fake = d_step(
            cfg, G, D, d_opt, reals[i], generator,
            None if noises is None else noises[i],
            None if alphas is None else alphas[i], replicas)
    err_g, fake = g_step(cfg, G, D, g_opt, reals.shape[1], reals.device,
                         generator,
                         None if noises is None else noises[cfg.iterD],
                         replicas)
    return global_metrics(replicas, err_real, err_fake, err_g), fake


def global_metrics(replicas: Replicas, err_real: torch.Tensor,
                   err_fake: torch.Tensor, err_g: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """The step's logged losses, each a mean over the rank's rows, as the
    global batch's (their mean over ranks, in one all-reduce)."""
    vals = replicas.mean([err_real.reshape(1), err_fake.reshape(1),
                          err_g.reshape(1)])
    return {"d_real": vals[0].reshape(()), "d_fake": vals[1].reshape(()),
            "g_loss": vals[2].reshape(())}

"""Host-side training loop (counterpart of gan3d_tpu/train/trainer.py).

Reference: trainer.py:28-313 (Trainer). One process a card; the step is
the fused D/G step of train/step.py, or for StyleGAN2 and StyleGAN-1 that of
models/stylegan/loss.py (StyleGAN2's lazy R1/PL step chosen on the host
by step % 16; StyleGAN-1's R1 on every step), run eagerly. Either step is
iterD D-step calls and one G-step call, which is what the JAX trainer's
split mode (``fused_step=False``, gan3d_tpu/train/trainer.py:284-324)
runs as separate programs; run eagerly there is no program to split, so
the flag is accepted and changes nothing. Kept from the JAX trainer:
- config persisted as ``params.json`` (``load_params`` reads it back);
- Adam(lr, betas=(0, 0.9)) per network, in the JAX op order;
- the log line ``[i|niters]\\tD(x): ..\\tD(G(z)): ..|..\\tFID ..`` every
  ``steps_per_log`` steps and at the end, with the axial slice FID of the
  G update's fake against the last D sub-batch's reals (``fid_in_loop``:
  the JAX trainer's decision table, ``_make_inloop_fid``; nan when off);
  with ``async_log`` a log step's sync, FID and print wait for the next
  flush point (the next log, image or checkpoint step, the first step or
  the end) and print that step's own values;
- the sample grid of a fixed noise batch every ``steps_per_img_log`` steps
  and at the end, with G in train mode as in the reference (its BN and SN
  state update during these forwards too);
- a rolling checkpoint every ``steps_per_ckpt`` steps and a final one, and
  automatic resume that prints ``starting from step N``; for both StyleGAN
  families it also holds ``pl_mean`` (StyleGAN-1's stays 0,
  gan3d_tpu/train/trainer.py:189), and for StyleGAN2 G's state seeds the
  EMA on resume (the reference's trainer.py:133-134; the EMA equals G's
  parameters after every G update);
- the closing ``...Done (...)`` line with the steady rate in vol/s;
- the hint printed for a BigGAN-family run at 128^3 or more without
  remat (``hint_128``);
- with ``profile_dir`` set, a ``torch.profiler`` trace of steps 5-9
  (utils/profiling.py) written there.

Noise is reproducible per (seed, step), like the JAX package's key folding:
every step draws from a generator seeded by (cfg.seed, step).

Data parallelism (gan3d_tpu/train/trainer.py:130-151, 347-350, 427,
461-469, 528-534): with ``replicas`` (parallel/dist.py, one process a
card; ``cli/train.py`` starts them) the trainer is one rank of
``cfg.num_devices`` (0 = every card). ``batch_size`` is the global batch
and must split over the ranks. Each rank runs its host's loader (seed
``cfg.seed`` + host, the host's batch ``B / hosts``) and takes its rows,
so one host's ranks see exactly the one-process run's batches; the step
draws the global batch's noise on every rank and all-reduces the
gradients (train/step.py). Rank 0 prints, writes the config, the PNGs,
the checkpoint (then a barrier; every rank resumes from it, at any world
size), the profiler trace and ``energy.json``, and computes the in-loop
FID on the gathered global fake and real. The samples of the PNG grid are
gathered too. After the last step the replica check (every parameter and
buffer bit-equal to rank 0's) runs and is printed. On the card the local
rank 0 builds the kernels the run needs before the others load them.
Without ``replicas`` a config that asks for more than one rank raises.

Tensor parallelism (gan3d_tpu/train/trainer.py:131-148, 216-223):
``model_devices`` > 1 makes the ranks a data x model grid (parallel/
dist.py); every rank builds both networks whole from the seed and keeps
its slices (parallel/tp.py), so Adam's moments and StyleGAN2's EMA are
shards too. Checkpoints stay whole, in the reference's layout: every rank
takes part in the gathers, rank 0 writes, and a resume slices, so a
checkpoint moves between a one-process run and any grid. The samples and
the in-loop FID run G on every rank (its forward is collective). The
replica check holds the replicated tensors alike on every rank and each
shard alike over its data group.

Spatial parallelism (gan3d_tpu/train/trainer.py:140-148, 207-213):
``spatial_devices`` > 1 makes the ranks a data x space grid (parallel/
dist.py); every rank holds both networks whole and its depth slab of every
activation (parallel/sp.py). A rank's reals are its rows and its slab of
their depth: every rank of a host assembles the host's batch from the
dataset on the host and uploads only its slab (iterD x B x R/S x R^2
f32 values a step). The samples of the PNG grid, the in-loop FID's fake
and ``async_log``'s deferred fake are gathered over space before rank
0's output work; checkpoints are whole (a resume works under another S),
and the replica check holds every tensor alike on every rank. Every
family runs under it: BigGAN, the DCGAN family, the hybrid, StyleGAN2
(its EMA alike on every rank) and StyleGAN-1; so do ``remat`` (each
group's recompute exchanges its halos and statistics again, in the same
order on every rank) and ``fused_step=False`` (the same step: each
update's gradients are made whole over space, then averaged over data).

``param_dtype`` is accepted and, as in the JAX package (whose modules fix
``param_dtype=jnp.float32``), the parameters stay f32.

``track_energy`` writes ``energy.json`` (utils/energy.py): the steps'
time, synchronized on the card, x the world size x a card's power limit.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.data.loader import Loader
from gan3d_tpu_torch.models.registry import build_models
from gan3d_tpu_torch.models.stylegan import loss as sg_loss
from gan3d_tpu_torch.nn.attention import SelfAttention3d
from gan3d_tpu_torch.ops.conv3d import set_fast_dw_mode, set_wide_conv_mode
from gan3d_tpu_torch.parallel import sp, tp
from gan3d_tpu_torch.parallel.dist import ONE, Replicas, plan_for
from gan3d_tpu_torch.train.checkpoint import CheckpointManager
from gan3d_tpu_torch.train.state import Adam
from gan3d_tpu_torch.train.step import train_step
from gan3d_tpu_torch.utils.energy import EnergyTracker, device_watts
from gan3d_tpu_torch.utils.platform import configure_precision, resolve_device
from gan3d_tpu_torch.utils.png import save_volume_grid
from gan3d_tpu_torch.utils.profiling import StepProfiler


def _reject_unported(cfg: Config) -> None:
    """Raise, as the JAX package's ``make_mesh`` and trainer do, on
    spatial and model parallelism together and on a resolution
    ``spatial_devices`` does not divide."""
    if cfg.spatial_devices > 1 and cfg.model_devices > 1:
        raise ValueError("spatial and model parallelism cannot be combined "
                         "yet — pick one of spatial_devices/model_devices")
    if cfg.spatial_devices > 1 and cfg.resolution % cfg.spatial_devices:
        raise ValueError(f"resolution {cfg.resolution} not divisible by "
                         f"spatial_devices {cfg.spatial_devices}")


def hint_128(cfg: Config) -> Optional[str]:
    """The JAX trainer's hint for 128^3 runs, on its condition
    (gan3d_tpu/train/trainer.py:121-128); None where it prints none."""
    if (cfg.resolution >= 128 and not cfg.remat
            and cfg.family() not in ("stylegan", "stylegan2")):
        return ("hint: at 128^3+, --remat=True --fused_step=False is "
                "usually required to fit HBM / the compiler; add "
                "--remat_scope=stage for larger batches (docs/PERF.md)")
    return None


# the pytorch-fid Inception weights the in-loop FID looks for in the cwd,
# then the log dir, when inception_weights is unset
INCEPTION_FILE = "pt_inception-2015-12-05-6726825d.pth"


def _nan_fid(fake, real) -> float:
    return float("nan")


def _seed(*words: int) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


def _world(cfg: Config, replicas: Optional[Replicas],
           device: torch.device) -> Replicas:
    """The run's ranks: ``replicas`` when given (its world must be the one
    ``num_devices`` asks for, 0 = any), else the one-process run on
    ``device``, which ``num_devices`` must allow (0 = every card: one card
    only)."""
    if replicas is None:
        p = plan_for(cfg, device.type)
        if p.parallel:
            raise ValueError(
                f"num_devices={cfg.num_devices} takes {p.world} ranks "
                f"({p.local} on this host): start the run with "
                "gan3d_tpu_torch.cli.train, which launches one process a "
                "card")
        return ONE
    if cfg.num_devices not in (0, replicas.world):
        raise ValueError(f"num_devices={cfg.num_devices} but the process "
                         f"group has {replicas.world} ranks")
    if cfg.model_devices != replicas.model:
        raise ValueError(f"model_devices={cfg.model_devices} but the "
                         f"process group's model groups have "
                         f"{replicas.model} ranks")
    if cfg.spatial_devices != replicas.space:
        raise ValueError(f"spatial_devices={cfg.spatial_devices} but the "
                         f"process group's space groups have "
                         f"{replicas.space} ranks")
    if replicas.device.type != device.type:
        raise ValueError(f"platform {cfg.platform!r} but the rank runs on "
                         f"{replicas.device}")
    return replicas


def _kernel_libraries(cfg: Config, G, D) -> List[str]:
    """The CUDA libraries a run launches (ops/cuda_build.py)."""
    libs = []
    if any(isinstance(m, SelfAttention3d) for net in (G, D)
           for m in net.modules()):
        libs.append("pooled_attention")
    if "on" in (cfg.wide_conv, cfg.fast_dw):
        libs.append("conv3d_k3")
    return libs


class Trainer:
    def __init__(self, dataset, cfg: Config,
                 replicas: Optional[Replicas] = None):
        self.log_dir = cfg.log_dir
        self.models_dir = os.path.join(self.log_dir, "models")
        self.images_dir = os.path.join(self.log_dir, "images")
        if cfg.load_params:
            cfg = Config.load(cfg.log_dir).replace(log_dir=cfg.log_dir)
        _reject_unported(cfg)
        device = resolve_device(cfg.platform)
        rp = self.replicas = _world(cfg, replicas, device)
        self.main = rp.main
        if cfg.batch_size % rp.data_world:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                             f"{rp.data_world} data-parallel devices")
        # the conv routes, before the models exist (as
        # gan3d_tpu/train/trainer.py:103-104); a mode outside MODES raises
        set_wide_conv_mode(cfg.wide_conv)
        set_fast_dw_mode(cfg.fast_dw)
        hint = hint_128(cfg)
        if hint and self.main:
            print(hint, flush=True)
        self.device = device if replicas is None else rp.device
        configure_precision(self.device)
        if self.main:
            os.makedirs(self.models_dir, exist_ok=True)
            os.makedirs(self.images_dir, exist_ok=True)
            if not cfg.load_params:
                cfg.save()
        self.cfg = cfg

        G, D = build_models(cfg, rp if replicas is not None else None)
        if cfg.gp_weight > 0 and self.device.type == "cuda" and any(
                isinstance(m, SelfAttention3d) for m in D.modules()):
            raise NotImplementedError(
                "the gradient penalty differentiates D twice, and the "
                "pooled-attention kernels' backward (K2, ops/cuda_attention"
                ".py) is first-order: on the card gp_weight > 0 takes a D "
                "without attention (ROADMAP.md queue A)")
        if self.device.type == "cuda" and rp.world > 1:
            # the host's first rank builds the kernels, the others load them
            if rp.local_rank == 0:
                from gan3d_tpu_torch.ops import cuda_build

                cuda_build.build(*_kernel_libraries(cfg, G, D))
            rp.barrier()
        self.G = G.to(self.device).train()
        self.D = D.to(self.device).train()
        self.tp = tp.on(rp)
        self.sp = sp.on(rp)
        self.stylegan2 = cfg.family() == "stylegan2"
        self.stylegan = self.stylegan2 or cfg.family() == "stylegan"
        # StyleGAN2's EMA of G (a copy of G, gan3d_tpu/train/trainer.py
        # :185-190) and path-length mean
        self.ema = ([p.detach().clone() for p in self.G.parameters()]
                    if self.stylegan2 else [])
        self.pl_mean = torch.zeros((), device=self.device)
        self.g_opt = Adam(self.G.parameters(), cfg.lrG, cfg.adam_b1,
                          cfg.adam_b2, mu_free=cfg.mu_free_adam)
        self.d_opt = Adam(self.D.parameters(), cfg.lrD, cfg.adam_b1,
                          cfg.adam_b2, mu_free=cfg.mu_free_adam)
        self.step = 0
        # the host's loader (gan3d_tpu/train/trainer.py:347-350): its
        # share of the global batch, its own seed; a rank takes its rows
        hosts = rp.world // rp.local_world
        self.loader = Loader(dataset, cfg.batch_size // hosts,
                             seed=cfg.seed + rp.host,
                             num_workers=cfg.data_loader_workers)
        self.ckpt = CheckpointManager(self.models_dir, rp)
        self.fixed_test_noise: Optional[torch.Tensor] = None
        self.G_losses: List[float] = []
        self.D_losses: List[List[float]] = []
        self.fid: List[float] = []
        self.fid_epoch: List[float] = []
        self._pending: List[Dict[str, torch.Tensor]] = []
        # async_log: a log step's (step, metrics, fake, real), printed at
        # the next flush point
        self._deferred: Optional[tuple] = None
        if self.main:
            self._fid_fn = self._make_inloop_fid()
        else:
            self._fid_fn, self._fid_active = _nan_fid, False
        self._fid_active = rp.agree(self._fid_active)
        self.profiler = StepProfiler(cfg.profile_dir if self.main else "",
                                     cuda=self.device.type == "cuda")
        self.energy = EnergyTracker(
            enabled=cfg.track_energy and self.main, n_chips=rp.world,
            watts_per_chip=(device_watts(self.device) if cfg.track_energy
                            and self.main else 0.0),
            device=self.device)

    # ------------------------------------------------------------------
    def _make_inloop_fid(self) -> Callable[..., float]:
        """The in-loop axial slice FID of fake against real, as the JAX
        trainer decides it (gan3d_tpu/train/trainer.py:373-412; the
        reference computes it every steps_per_log, trainer.py:100-110).
        ``fid_in_loop``: None = Inception FID when weights are found
        (``inception_weights``, else INCEPTION_FILE in the cwd, then the
        log dir), else a warning and nan; True = the same, with the random
        stand-in when no weights are found; False = nan. A weights file
        that fails to load disables it with a message. Reads only
        ``cfg``, ``log_dir`` and ``device``; sets ``_fid_active``."""
        mode = self.cfg.fid_in_loop
        self._fid_active = False
        if mode is False:
            return _nan_fid
        weights = self.cfg.inception_weights
        if not weights:
            for d in (os.getcwd(), self.log_dir):
                cand = os.path.join(d, INCEPTION_FILE)
                if os.path.isfile(cand):
                    weights = cand
                    break
        from gan3d_tpu_torch.eval.slice_fid import SliceFID

        if weights and os.path.isfile(weights):
            try:
                sfid = SliceFID(weights_path=weights, device=self.device)
            except Exception as e:  # noqa: BLE001 — a bad weights file
                # must not stop training: report it and log nan
                print(f"in-loop FID disabled: {e}", flush=True)
                return _nan_fid
            self._fid_active = True
            return sfid.axial
        if mode is True:  # asked for without weights: the stand-in
            self._fid_active = True
            return SliceFID(device=self.device).axial
        print("in-loop FID: no Inception weights found (set "
              "cfg.inception_weights); logging FID as nan. The reference "
              "computes slice-FID every steps_per_log (trainer.py:100-110).",
              flush=True)
        return _nan_fid

    # ------------------------------------------------------------------
    def _generator(self, *words: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(_seed(self.cfg.seed, *words))
        return g

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _flush_pending(self) -> None:
        for m in self._pending:
            self.D_losses.append([float(m["d_real"]), float(m["d_fake"])])
            self.G_losses.append(float(m["g_loss"]))
        self._pending.clear()

    def log_train(self, step: int, fake: Optional[torch.Tensor],
                  real: Optional[torch.Tensor], metrics=None) -> None:
        """Append the FID of ``fake`` (the G update's batch, in the compute
        dtype, as the JAX trainer passes it; the extractors compute in
        f32) against ``real`` (the last D sub-batch, f32 on the host) and
        print the log line: ``metrics``' values when given (a deferred
        line), else the latest step's. No fake (a resumed run with no step
        left) logs nan. In a data-parallel run every rank calls it: the FID
        takes the global fake and real (gathered), on rank 0, which alone
        prints."""
        if fake is None:
            self.fid.append(float("nan"))
        elif self._fid_active and self.replicas.world > 1:
            fake = self.replicas.all_gather(self._whole(fake))
            real = self.replicas.all_gather(real.to(self.device)).cpu()
            self.fid.append(self._fid_fn(fake, real) if self.main
                            else float("nan"))
        else:
            self.fid.append(self._fid_fn(fake, real))
        self._flush_pending()
        if not self.main:
            return
        if metrics is not None:
            d_real, d_fake = float(metrics["d_real"]), float(metrics["d_fake"])
            g_loss = float(metrics["g_loss"])
        elif self.G_losses:
            (d_real, d_fake), g_loss = self.D_losses[-1], self.G_losses[-1]
        else:
            return
        print("[%d|%d]\tD(x): %.4f\tD(G(z)): %.4f|%.4f\tFID %.4f"
              % (step, self.cfg.niters, d_real, d_fake, g_loss,
                 self.fid[-1]), flush=True)

    def _whole(self, fake: torch.Tensor) -> torch.Tensor:
        """A G output with its depth whole (gathered over space, not
        differentiable)."""
        if self.sp and sp.is_sharded(fake):
            return tp.all_gather(fake, 2, self.replicas.space_axis)
        return fake

    def _flush_deferred(self) -> None:
        if self._deferred is not None:
            step, metrics, fake, real = self._deferred
            self._deferred = None
            self.log_train(step, fake, real, metrics=metrics)

    def log_interpolation(self, step: int) -> None:
        """The sample grid of the fixed noise (the rank's rows of it; the
        samples gathered, rank 0 writes the PNG)."""
        if self.fixed_test_noise is None:
            self.fixed_test_noise = self.replicas.rows(torch.randn(
                (self.cfg.batch_size, self.cfg.z_size),
                generator=self._generator(2), device=self.device))
        with torch.no_grad():
            if self.stylegan2:
                fake = self.G(self.fixed_test_noise,
                              generator=self._generator(3, step))[0]
            elif self.stylegan:
                # StyleGAN-1's mixing draws (_apply_g's "mixing" key)
                fake = self.G(self.fixed_test_noise,
                              generator=self._generator(3, step))
            else:
                fake = self.G(self.fixed_test_noise)
            fake = self.replicas.all_gather(self._whole(fake))
        if self.main:
            save_volume_grid(os.path.join(self.images_dir, f"{step}.png"),
                             fake.float().cpu().numpy()[:, 0])

    def log(self, step: int, fake: torch.Tensor, real: torch.Tensor,
            metrics: Dict[str, torch.Tensor]) -> None:
        if step % self.cfg.steps_per_log == 0:
            if self.cfg.async_log:
                self._flush_deferred()
                self._deferred = (step, metrics, fake, real)
            else:
                self.log_train(step, fake, real)
        if step % self.cfg.steps_per_img_log == 0:
            self._flush_deferred()  # keep the [step] line ahead of its PNG
            self.log_interpolation(step)

    # ------------------------------------------------------------------
    def _state_dict(self, net: torch.nn.Module) -> dict:
        """``net``'s state_dict, whole (under a model axis every rank takes
        part in the gathers)."""
        if self.tp:
            return tp.full_state_dict(net, self.replicas)
        return net.state_dict()

    def _opt_state(self, opt: Adam) -> dict:
        sd = opt.state_dict()
        if self.tp:
            for k in ("nu", "mu"):
                if sd[k] is not None:
                    sd[k] = tp.full_moments(opt.params, sd[k], self.replicas)
        return sd

    def save_checkpoint(self) -> None:
        self._flush_pending()
        payload = {
            "step": self.step,
            "modelG_state_dict": self._state_dict(self.G),
            "modelD_state_dict": self._state_dict(self.D),
            "optimizerG_state_dict": self._opt_state(self.g_opt),
            "optimizerD_state_dict": self._opt_state(self.d_opt),
            "lossG": self.G_losses, "lossD": self.D_losses,
            "fid": self.fid_epoch,
        }
        if self.stylegan:
            payload["pl_mean"] = self.pl_mean
        self.ckpt.save(payload)

    def start_from_checkpoint(self) -> int:
        payload = self.ckpt.restore(self.device)
        if payload is None:
            return 0
        for net, opt, tag in ((self.G, self.g_opt, "G"),
                              (self.D, self.d_opt, "D")):
            sd, osd = (payload[f"model{tag}_state_dict"],
                       payload[f"optimizer{tag}_state_dict"])
            if self.tp:  # a whole checkpoint: this rank's slices
                tp.load_full_state_dict(net, sd, self.replicas)
                osd = {**osd, **{k: tp.local_moments(opt.params, osd[k],
                                                     self.replicas)
                                 for k in ("nu", "mu")
                                 if osd[k] is not None}}
            else:
                net.load_state_dict(sd)
            opt.load_state_dict(osd)
        if self.stylegan:
            self.pl_mean = payload["pl_mean"].to(self.device)
        if self.stylegan2:
            self.ema = [p.detach().clone() for p in self.G.parameters()]
        self.G_losses = list(payload["lossG"])
        self.D_losses = [list(x) for x in payload["lossD"]]
        self.fid_epoch = list(payload["fid"])
        self.step = int(payload["step"])
        if self.main:
            print(f"starting from step {self.step}", flush=True)
        return self.step

    def _reals(self, batches) -> tuple:
        """([iterD, B, 1, R, R, R] f32 on the device, the last D sub-batch
        [B, R, R, R] f32 on the host: a view of the same host array), B
        the rank's rows of its host's batch; under a space axis the
        device's reals are the rank's depth slab [iterD, B, 1, R/S, R, R]
        and the host's sub-batch stays whole."""
        host = torch.from_numpy(np.stack([next(batches)
                                          for _ in range(self.cfg.iterD)]))
        rp = self.replicas
        # the host's data ranks (a model or space group lies on one host)
        local = rp.local_world // rp.inner
        if local > 1:
            b = host.shape[1] // local
            i = rp.local_rank // rp.inner
            host = host[:, i * b:(i + 1) * b]
        dev = host
        if self.sp and sp.shards(host.shape[2], rp):
            dev = host[:, :, slice(*sp.span(host.shape[2], rp))]
        return dev.to(self.device).unsqueeze(2), host[-1]

    def replica_tensors(self) -> Tuple[List[torch.Tensor],
                                       List[torch.Tensor]]:
        """(what every rank must hold alike, what every rank of a data
        group must: the shards): both networks' parameters and buffers
        (the running stats synced over the model group first), both
        optimizers' moments, StyleGAN2's EMA and the path-length mean."""
        for net in (self.G, self.D):
            tp.sync_buffers(net, self.replicas)
        rep, shards = [], []
        for net in (self.G, self.D):
            for p in net.parameters():
                (shards if tp.sharded(p) else rep).append(p)
            rep += list(net.buffers())
        for opt in (self.g_opt, self.d_opt):
            for p, *moments in zip(opt.params, opt.nu, *(
                    [opt.mu] if opt.mu is not None else [])):
                (shards if tp.sharded(p) else rep).extend(moments)
        for p, e in zip(self.g_opt.params, self.ema):
            (shards if tp.sharded(p) else rep).append(e)
        return rep + [self.pl_mean.reshape(1)], shards

    # ------------------------------------------------------------------
    def train(self) -> None:
        cfg = self.cfg
        step_done = self.start_from_checkpoint()
        batches = self.loader.infinite()
        if self.main:
            print("Starting Training...", flush=True)
        t0 = t_first = time.time()
        fake = real = None
        rp = self.replicas
        try:
            for i in range(step_done, cfg.niters):
                self.profiler.step(i)
                reals, real = self._reals(batches)
                gen = self._generator(1, i)
                self.energy.epoch_start()
                if self.stylegan:
                    metrics, fake, self.pl_mean = sg_loss.train_step(
                        cfg, self.G, self.D, self.g_opt, self.d_opt, reals,
                        i, self.ema, self.pl_mean, generator=gen,
                        replicas=rp)
                else:
                    metrics, fake = train_step(cfg, self.G, self.D,
                                               self.g_opt, self.d_opt, reals,
                                               generator=gen, replicas=rp)
                self.energy.epoch_end()
                self.step = i + 1
                self._pending.append(metrics)
                self.log(i, fake, real, metrics)
                if i == step_done:
                    # sync the first step: t_first marks "set-up + first
                    # step", so the steady rate excludes it.
                    self._flush_deferred()
                    self._sync()
                    t_first = time.time()
                if i % cfg.steps_per_ckpt == 0 and i > 0:
                    self._flush_deferred()  # the fid list takes this step
                    vals = [v for v in self.fid if not math.isnan(v)]
                    self.fid_epoch.append(float(np.mean(vals)) if vals
                                          else float("nan"))
                    self.fid = []
                    self.save_checkpoint()
        finally:
            batches.close()
            self.loader.close()
        self.profiler.close()
        if self.main:
            self.energy.write(self.log_dir)
        i = cfg.niters - 1
        self._flush_deferred()
        self.log_train(i, fake, real)
        self._sync()
        t_last_sync = time.time()
        self.log_interpolation(i)
        self.save_checkpoint()
        dt = time.time() - t0
        if rp.world > 1:
            n = rp.check(*self.replica_tensors())
            if self.main:
                print(f"replica check: {n} tensors bit-equal to rank 0's on "
                      f"all {rp.world} ranks", flush=True)
        n_steps = cfg.niters - step_done
        if n_steps > 0 and self.main:
            msg = (f"...Done ({n_steps} steps in {dt:.1f}s, "
                   f"{n_steps / dt:.2f} steps/s")
            if n_steps > 1:
                steady = (n_steps - 1) / max(t_last_sync - t_first, 1e-9)
                msg += (f"; steady {steady:.2f} steps/s = "
                        f"{steady * cfg.batch_size:.1f} vol/s")
            print(msg + ")", flush=True)


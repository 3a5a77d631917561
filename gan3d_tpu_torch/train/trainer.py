"""Host-side training loop (counterpart of gan3d_tpu/train/trainer.py).

Reference: trainer.py:28-313 (Trainer). One device; the step is the fused
D/G step of train/step.py, or for StyleGAN2 and StyleGAN-1 that of
models/stylegan/loss.py (StyleGAN2's lazy R1/PL step chosen on the host
by step % 16; StyleGAN-1's R1 on every step), run eagerly. Kept from the
JAX trainer:
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
- with ``profile_dir`` set, a ``torch.profiler`` trace of steps 5-9
  (utils/profiling.py) written there.

Noise is reproducible per (seed, step), like the JAX package's key folding:
every step draws from a generator seeded by (cfg.seed, step).
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.data.loader import Loader
from gan3d_tpu_torch.models.registry import build_models
from gan3d_tpu_torch.models.stylegan import loss as sg_loss
from gan3d_tpu_torch.nn.attention import SelfAttention3d
from gan3d_tpu_torch.ops.conv3d import set_fast_dw_mode, set_wide_conv_mode
from gan3d_tpu_torch.train.checkpoint import CheckpointManager
from gan3d_tpu_torch.train.state import Adam
from gan3d_tpu_torch.train.step import train_step
from gan3d_tpu_torch.utils.platform import configure_precision, resolve_device
from gan3d_tpu_torch.utils.png import save_volume_grid
from gan3d_tpu_torch.utils.profiling import StepProfiler


def _reject_unported(cfg: Config) -> None:
    """Raise on options whose code paths the port does not have yet."""
    later = []
    if cfg.num_devices > 1 or cfg.spatial_devices > 1 \
            or cfg.model_devices > 1 or cfg.distributed:
        later.append("multi-device runs (ROADMAP.md queue A, slice 8)")
    if cfg.track_energy:
        later.append("energy tracking (ROADMAP.md queue A, slice 8)")
    if not cfg.fused_step:
        later.append("the split D/G step (fused_step=False)")
    if cfg.param_dtype != "float32":
        later.append(f"param_dtype={cfg.param_dtype!r}")
    if later:
        raise NotImplementedError("not ported yet: " + "; ".join(later))


# the pytorch-fid Inception weights the in-loop FID looks for in the cwd,
# then the log dir, when inception_weights is unset
INCEPTION_FILE = "pt_inception-2015-12-05-6726825d.pth"


def _nan_fid(fake, real) -> float:
    return float("nan")


def _seed(*words: int) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


class Trainer:
    def __init__(self, dataset, cfg: Config):
        self.log_dir = cfg.log_dir
        self.models_dir = os.path.join(self.log_dir, "models")
        self.images_dir = os.path.join(self.log_dir, "images")
        if cfg.load_params:
            cfg = Config.load(cfg.log_dir).replace(log_dir=cfg.log_dir)
        _reject_unported(cfg)
        # the conv routes, before the models exist (as
        # gan3d_tpu/train/trainer.py:103-104); a mode outside MODES raises
        set_wide_conv_mode(cfg.wide_conv)
        set_fast_dw_mode(cfg.fast_dw)
        self.device = resolve_device(cfg.platform)
        configure_precision(self.device)
        os.makedirs(self.models_dir, exist_ok=True)
        os.makedirs(self.images_dir, exist_ok=True)
        if not cfg.load_params:
            cfg.save()
        self.cfg = cfg

        G, D = build_models(cfg)
        if cfg.gp_weight > 0 and self.device.type == "cuda" and any(
                isinstance(m, SelfAttention3d) for m in D.modules()):
            raise NotImplementedError(
                "the gradient penalty differentiates D twice, and the "
                "pooled-attention kernels' backward (K2, ops/cuda_attention"
                ".py) is first-order: on the card gp_weight > 0 takes a D "
                "without attention (ROADMAP.md queue A)")
        self.G = G.to(self.device).train()
        self.D = D.to(self.device).train()
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
        self.loader = Loader(dataset, cfg.batch_size, seed=cfg.seed,
                             num_workers=cfg.data_loader_workers)
        self.ckpt = CheckpointManager(self.models_dir)
        self.fixed_test_noise: Optional[torch.Tensor] = None
        self.G_losses: List[float] = []
        self.D_losses: List[List[float]] = []
        self.fid: List[float] = []
        self.fid_epoch: List[float] = []
        self._pending: List[Dict[str, torch.Tensor]] = []
        # async_log: a log step's (step, metrics, fake, real), printed at
        # the next flush point
        self._deferred: Optional[tuple] = None
        self._fid_fn = self._make_inloop_fid()
        self.profiler = StepProfiler(cfg.profile_dir,
                                     cuda=self.device.type == "cuda")

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
        left) logs nan."""
        self.fid.append(float("nan") if fake is None
                        else self._fid_fn(fake, real))
        self._flush_pending()
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

    def _flush_deferred(self) -> None:
        if self._deferred is not None:
            step, metrics, fake, real = self._deferred
            self._deferred = None
            self.log_train(step, fake, real, metrics=metrics)

    def log_interpolation(self, step: int) -> None:
        if self.fixed_test_noise is None:
            self.fixed_test_noise = torch.randn(
                (self.cfg.batch_size, self.cfg.z_size),
                generator=self._generator(2), device=self.device)
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
    def save_checkpoint(self) -> None:
        self._flush_pending()
        payload = {
            "step": self.step,
            "modelG_state_dict": self.G.state_dict(),
            "modelD_state_dict": self.D.state_dict(),
            "optimizerG_state_dict": self.g_opt.state_dict(),
            "optimizerD_state_dict": self.d_opt.state_dict(),
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
        self.G.load_state_dict(payload["modelG_state_dict"])
        self.D.load_state_dict(payload["modelD_state_dict"])
        self.g_opt.load_state_dict(payload["optimizerG_state_dict"])
        self.d_opt.load_state_dict(payload["optimizerD_state_dict"])
        if self.stylegan:
            self.pl_mean = payload["pl_mean"].to(self.device)
        if self.stylegan2:
            self.ema = [p.detach().clone() for p in self.G.parameters()]
        self.G_losses = list(payload["lossG"])
        self.D_losses = [list(x) for x in payload["lossD"]]
        self.fid_epoch = list(payload["fid"])
        self.step = int(payload["step"])
        print(f"starting from step {self.step}", flush=True)
        return self.step

    def _reals(self, batches) -> tuple:
        """([iterD, B, 1, R, R, R] f32 on the device, the last D sub-batch
        [B, R, R, R] f32 on the host: a view of the same host array)."""
        host = torch.from_numpy(np.stack([next(batches)
                                          for _ in range(self.cfg.iterD)]))
        return host.to(self.device).unsqueeze(2), host[-1]

    # ------------------------------------------------------------------
    def train(self) -> None:
        cfg = self.cfg
        step_done = self.start_from_checkpoint()
        batches = self.loader.infinite()
        print("Starting Training...", flush=True)
        t0 = t_first = time.time()
        fake = real = None
        try:
            for i in range(step_done, cfg.niters):
                self.profiler.step(i)
                reals, real = self._reals(batches)
                gen = self._generator(1, i)
                if self.stylegan:
                    metrics, fake, self.pl_mean = sg_loss.train_step(
                        cfg, self.G, self.D, self.g_opt, self.d_opt, reals,
                        i, self.ema, self.pl_mean, generator=gen)
                else:
                    metrics, fake = train_step(cfg, self.G, self.D,
                                               self.g_opt, self.d_opt, reals,
                                               generator=gen)
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
        i = cfg.niters - 1
        self._flush_deferred()
        self.log_train(i, fake, real)
        self._sync()
        t_last_sync = time.time()
        self.log_interpolation(i)
        self.save_checkpoint()
        dt = time.time() - t0
        n_steps = cfg.niters - step_done
        if n_steps > 0:
            msg = (f"...Done ({n_steps} steps in {dt:.1f}s, "
                   f"{n_steps / dt:.2f} steps/s")
            if n_steps > 1:
                steady = (n_steps - 1) / max(t_last_sync - t_first, 1e-9)
                msg += (f"; steady {steady:.2f} steps/s = "
                        f"{steady * cfg.batch_size:.1f} vol/s")
            print(msg + ")", flush=True)


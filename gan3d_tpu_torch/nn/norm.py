"""Normalization layers (counterparts of gan3d_tpu/nn/norm.py).

- BatchNorm3d (norm.py:93-118): torch's own BatchNorm3d has the semantics
  the JAX package copies from it: statistics over the whole batch (the JAX
  ``num_groups=1`` path), biased variance for the normalization, unbiased
  variance for the running-stat update, momentum 0.1, eps 1e-5. Parameters
  and running stats are f32; a bf16 input is normalized with f32
  statistics (CUDA's batch norm accumulates in f32) and comes back in
  bf16. ``std`` draws the scale from N(1, std) (the DCGAN's init,
  gan3d_tpu/models/dcgan.py:39-40). Its statistics scopes (norm.py
  :40-110), in train mode:
  - one process, ``num_groups`` 1: the whole batch, torch's own kernel;
  - ``num_groups`` G > 1 (norm.py:73-92): statistics per contiguous group
    of N/G samples (a batch that G does not divide takes the whole batch,
    as in the JAX package); the running stats move by the mean over the
    groups of each group's mean and unbiased variance;
  - ``replicas`` of world > 1 with ``sync`` (cross-replica, norm.py
    :93-110): the statistics of the global batch (``n`` the global
    count). Each rank's per-channel mean and centred sum of squares, in
    f32, go through one differentiable all-gather a call (the scheme of
    torch.nn.SyncBatchNorm) and combine as Chan et al.'s parallel
    variance, where the JAX package's pmean of E[x] and E[x^2] would lose
    ~1e-5 of a BN scale's gradient to cancellation in f32; at world 1 the
    one-process path runs, as torch.nn.SyncBatchNorm does;
  - ``replicas`` of world > 1 without ``sync`` (``cfg.sync_bn=False``):
    each rank's batch is its group, and the running-stat updates are
    averaged over ranks, so every replica keeps the same buffers; that
    is the grouped scope with a group a rank.
  Every scope normalizes with the biased variance (two-pass: the mean,
  then the centred squares) and updates the running stats with the
  unbiased one, momentum 0.1. The ranks of a scope are the data group
  (parallel/dist.py). Under a model axis an input that holds this rank's
  slice of the channels (parallel/tp.py) is normalized with the affine's
  and the running stats' slice (``tp_span``), which alone it updates;
  without a scope across ranks or groups that is torch's own kernel on
  the slice.
- LayerNormVolume (norm.py:121-144): torch's LayerNorm over [C, D, H, W]
  of an NCDHW input, per sample, eps 1e-5, with a full-shape affine
  [C, D, H, W] (the JAX scale and bias are (D, H, W, C): the transpose
  (3, 0, 1, 2) maps them, as gan3d_tpu/eval/export.py:_layernorm_out
  does). Statistics in at least f32 (``_stat_dtype``, norm.py:31-34); the
  output in the input's dtype. The WGAN DCGAN discriminator's norm. On
  a slice of the channels (the affine sharded with them) the per-sample
  mean and centred sum of squares are summed over the model group.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan3d_tpu_torch.parallel import tp


class BatchNorm3d(nn.BatchNorm3d):
    def __init__(self, num_features: int, std: Optional[float] = None,
                 num_groups: int = 1):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        if std is not None:
            nn.init.normal_(self.weight, 1.0, std)
        self.num_groups = num_groups
        self.sync = True        # cross-replica statistics under ``replicas``
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rp = self.replicas
        world = 1 if rp is None else rp.data_world
        g = self.num_groups if x.shape[0] % self.num_groups == 0 else 1
        lo, hi = 0, self.num_features
        w, b = self.weight, self.bias
        local = tp.on(rp) and tp.is_local(x, self.num_features)
        if local:
            lo, hi = self.tp_span = tp.span(rp, self.num_features)
            w, b = tp.sliced(w, lo, hi), tp.sliced(b, lo, hi)
        if not self.training or (g == 1 and world == 1):
            if not local:
                return super().forward(x)
            # torch's kernel on the slice: its statistics are per channel
            if self.training:
                self.num_batches_tracked.add_(1)
            return F.batch_norm(x, self.running_mean[lo:hi],
                                self.running_var[lo:hi], w, b, self.training,
                                self.momentum, self.eps)
        sdt = torch.promote_types(x.dtype, torch.float32)
        n, c = x.shape[:2]
        xg = x.to(sdt).reshape(g, n // g, c, -1)
        cnt = (n // g) * xg.shape[-1]
        mean = xg.mean(dim=(1, 3))                                # [g, c]
        m2 = (xg - mean[:, None, :, None]).square().sum(dim=(1, 3))
        across = world > 1 and self.sync
        if across:
            # every rank's (mean, m2) of the same count
            means, m2s = rp.all_gather(torch.stack([mean, m2])[None]
                                       ).unbind(1)            # [world, g, c]
            mean = means.mean(dim=0)
            m2 = m2s.sum(dim=0) + cnt * (means - mean).square().sum(dim=0)
            cnt *= world
        var = m2 / cnt
        y = ((xg - mean[:, None, :, None])
             * torch.rsqrt(var + self.eps)[:, None, :, None]).reshape(x.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = y * w.to(sdt).reshape(shape) + b.to(sdt).reshape(shape)
        with torch.no_grad():
            upd = [mean.mean(dim=0),
                   (var * (cnt / max(cnt - 1, 1))).mean(dim=0)]
            if world > 1 and not across:
                upd = rp.mean(upd)
            m = self.momentum
            self.running_mean[lo:hi].mul_(1 - m).add_(upd[0] * m)
            self.running_var[lo:hi].mul_(1 - m).add_(upd[1] * m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


class LayerNormVolume(nn.LayerNorm):
    def __init__(self, shape: Sequence[int]):
        super().__init__(tuple(shape), eps=1e-5)
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sdt = torch.promote_types(x.dtype, torch.float32)
        c = self.normalized_shape[0]
        rp = self.replicas
        if tp.on(rp) and tp.is_local(x, c):
            return self._local(x, sdt, rp)
        return F.layer_norm(x.to(sdt), self.normalized_shape,
                            self.weight.to(sdt), self.bias.to(sdt),
                            self.eps).to(x.dtype)

    def _local(self, x: torch.Tensor, sdt: torch.dtype, rp) -> torch.Tensor:
        """This rank's channels of the whole input's LayerNorm."""
        xs = x.to(sdt)
        dims = tuple(range(1, x.dim()))
        cnt = xs[0].numel() * rp.model
        # whole per-sample statistics that meet this rank's channels only
        mean = tp.copy(tp.reduce(xs.sum(dim=dims), rp), rp) / cnt
        d = xs - mean.reshape((-1,) + (1,) * len(dims))
        var = tp.copy(tp.reduce(d.square().sum(dim=dims), rp), rp) / cnt
        y = d * torch.rsqrt(var + self.eps).reshape(mean.shape[:1]
                                                    + (1,) * len(dims))
        w, b = self.weight, self.bias
        if w.shape[0] != x.shape[1]:  # the affine replicated: its slice
            lo, hi = tp.span(rp, w.shape[0])
            w, b = tp.sliced(w, lo, hi), tp.sliced(b, lo, hi)
        return (y * w.to(sdt) + b.to(sdt)).to(x.dtype)

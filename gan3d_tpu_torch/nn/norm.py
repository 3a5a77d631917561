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
    as the JAX package's ``_bn_groups`` (gan3d_tpu/models/registry.py
    :20-27), a group of batch / world samples a device of the run,
    every device counted (a model or space group's too): a rank's rows
    hold world / data_world groups (one under data parallelism alone),
    and the running-stat updates are averaged over the data group, so
    every replica keeps the same buffers; a global batch the world does
    not divide takes the whole batch's statistics, as in JAX.
  Every scope normalizes with the biased variance (two-pass: the mean,
  then the centred squares) and updates the running stats with the
  unbiased one, momentum 0.1. The ranks of a scope are the data group
  (parallel/dist.py). Under a model axis an input that holds this rank's
  slice of the channels (parallel/tp.py) is normalized with the affine's
  and the running stats' slice (``tp_span``), which alone it updates;
  without a scope across ranks or groups that is torch's own kernel on
  the slice. Under a space axis (parallel/sp.py) an input that holds this
  rank's depth slab takes its statistics over the space group too (and
  over every rank with ``sync``), through ``_SlabBatchNorm``: its forward
  combines each rank's per-channel mean and centred sum of squares as
  above, and it saves the input alone, as torch's kernel does (the
  explicit formula's autograd would save three full-size f32 tensors);
  on a bf16 slab on the card its passes are torch's SyncBatchNorm
  kernels, which read it as it is and sum in f32 (a 256^3 slab at the
  flagship's widths holds 2^32 values and more at batch 16: a full-size
  f32 copy would not fit), on an f32 slab or the CPU the explicit
  formula (``_native``); its
  backward all-reduces the two per-channel sums of the gradient over
  the same ranks (torch.nn.SyncBatchNorm's scheme) and is first-order, as
  no loss of these families differentiates G twice. Its affine then has
  a partial gradient (``sp.mark``). At a data group of one, ``sync``'s
  all-reduces run on the space group's communicator, which has the same
  ranks (``slab_scope``): two NCCL communicators over the same two cards
  were the suspects of a hang at 128^3 (PERF.md).
- LayerNormVolume (norm.py:121-144): torch's LayerNorm over [C, D, H, W]
  of an NCDHW input, per sample, eps 1e-5, with a full-shape affine
  [C, D, H, W] (the JAX scale and bias are (D, H, W, C): the transpose
  (3, 0, 1, 2) maps them, as gan3d_tpu/eval/export.py:_layernorm_out
  does). Statistics in at least f32 (``_stat_dtype``, norm.py:31-34); the
  output in the input's dtype. The WGAN DCGAN discriminator's norm. On
  a slice of the channels (the affine sharded with them) the per-sample
  mean and centred sum of squares are summed over the model group; on a
  depth slab, over the space group, with the affine's depth slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gan3d_tpu_torch.parallel import sp, tp


def _native(x: torch.Tensor) -> bool:
    """Whether the slab BatchNorm runs torch's SyncBatchNorm kernels on
    ``x`` rather than the explicit formula: a bf16 (or f16) slab on the
    card, which the formula would copy whole to f32. An f32 slab keeps
    the formula, whose rounding holds a sharded f32 run to one process
    within the spatial checks' limits (torch's kernels put a DCGAN
    ``--msl`` step's losses 1.54e-4 from one process's on an H100, past
    the 1e-4 the formula met)."""
    return x.is_cuda and x.element_size() < 4


class _SlabBatchNorm(torch.autograd.Function):
    """BatchNorm's train-mode forward on ``x`` [N, C, ...] in ``groups``
    groups of rows, each group's statistics combined over the ``n`` ranks
    of ``group`` (this one ``rank``), which hold the same count; returns
    (y, the combined mean [groups, C], the biased variance, the count).
    A bf16 input on the card takes torch's SyncBatchNorm kernels (a group
    of rows a call), any other the explicit formula in at least f32."""

    @staticmethod
    def forward(ctx, x, w, b, groups, group, n, rank, eps):
        rows, c = x.shape[:2]
        cnt = rows // groups * x[0, 0].numel()
        if _native(x):
            parts = x.chunk(groups)
            # at eps 0 the kernel's invstd gives back the biased variance
            mean, inv = (torch.stack(t) for t in zip(
                *(torch.batch_norm_stats(p, 0.0) for p in parts)))
            m2 = cnt / inv.square()
        else:
            sdt = torch.promote_types(x.dtype, torch.float32)
            xf = x.reshape(groups, rows // groups, c, -1).to(sdt)
            mean = xf.mean(dim=(1, 3))                           # [g, c]
            m2 = (xf - mean[:, None, :, None]).square().sum(dim=(1, 3))
        every = x.new_zeros((n, 2) + tuple(mean.shape), dtype=mean.dtype)
        every[rank] = torch.stack([mean, m2])
        dist.all_reduce(every, group=group)
        means, m2s = every.unbind(1)                          # [n, g, c]
        mean = means.mean(dim=0)
        m2 = m2s.sum(dim=0) + cnt * (means - mean).square().sum(dim=0)
        var = m2 / (cnt * n)
        invstd = torch.rsqrt(var + eps)
        if _native(x):
            ys = [torch.batch_norm_elemt(p, w, b, mu, i, eps)
                  for p, mu, i in zip(parts, mean, invstd)]
            y = ys[0] if groups == 1 else torch.cat(ys)
        else:
            y = ((xf - mean[:, None, :, None]) * invstd[:, None, :, None]
                 * w.to(sdt)[:, None] + b.to(sdt)[:, None]
                 ).reshape(x.shape).to(x.dtype)
        ctx.save_for_backward(x, mean, invstd, w)
        ctx.groups, ctx.cnt, ctx.n, ctx.group = groups, cnt, n, group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var, cnt * n

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, _mean, _var, _cnt):
        x, mean, invstd, w = ctx.saved_tensors
        sdt = mean.dtype
        rows, c = x.shape[:2]
        if _native(x):
            parts, gparts = x.chunk(ctx.groups), gy.contiguous().chunk(
                ctx.groups)
            # each group's sums of dy and of dy (x - mean), then of dy xhat
            s, sx = (torch.stack(t) for t in zip(*(
                torch.batch_norm_backward_reduce(
                    g, p, mu, i, w, True, False, False)[:2]
                for g, p, mu, i in zip(gparts, parts, mean, invstd))))
            sums = torch.stack([s, sx * invstd])
        else:
            shape = (ctx.groups, rows // ctx.groups, c, -1)
            xhat = ((x.reshape(shape).to(sdt) - mean[:, None, :, None])
                    * invstd[:, None, :, None])
            g = gy.reshape(shape).to(sdt)
            sums = torch.stack([g.sum(dim=(1, 3)),
                                (g * xhat).sum(dim=(1, 3))])   # [2, g, c]
        dw, db = sums[1].sum(dim=0), sums[0].sum(dim=0)   # this rank's part
        dist.all_reduce(sums, group=ctx.group)
        if _native(x):
            count = torch.full((ctx.n,), ctx.cnt, dtype=torch.int32,
                               device=x.device)
            dxs = [torch.batch_norm_backward_elemt(g, p, mu, i, w, s, sx / i,
                                                   count)
                   for g, p, mu, i, s, sx in zip(gparts, parts, mean,
                                                 invstd, *sums)]
            dx = dxs[0] if ctx.groups == 1 else torch.cat(dxs)
        else:
            total = ctx.cnt * ctx.n
            dx = ((g - (sums[0] / total)[:, None, :, None]
                   - xhat * (sums[1] / total)[:, None, :, None])
                  * (w.to(sdt)[:, None] * invstd[:, None, :, None])
                  ).reshape(x.shape).to(x.dtype)
        return (dx, dw.to(w.dtype), db.to(w.dtype), None, None, None, None,
                None)


def slab_scope(rp, sync: bool) -> tuple:
    """(process group, ranks, this one's place) of a slab BatchNorm's
    statistics: every rank with ``sync``, else the space group. Where the
    two have the same ranks (a data group of one) the space group's
    communicator runs both, so the halo exchanges and the statistics
    share one NCCL communicator and one order on every rank."""
    if sync and rp.data_world > 1:
        return rp.group, rp.world, rp.rank
    return rp.space_group, rp.space, rp.space_rank


class BatchNorm3d(nn.BatchNorm3d):
    def __init__(self, num_features: int, std: Optional[float] = None,
                 num_groups: int = 1):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        if std is not None:
            nn.init.normal_(self.weight, 1.0, std)
        self.num_groups = num_groups
        self.sync = True        # cross-replica statistics under ``replicas``
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def _scope(self, x: torch.Tensor) -> tuple:
        """(groups of this rank's rows, whether the statistics span the
        data group): the JAX rule's groups a device without ``sync``."""
        rp = self.replicas
        if rp is not None and rp.world > 1 and not self.sync:
            per = rp.world // rp.data_world
            if x.shape[0] % per == 0:
                return per, False
            return 1, True  # the JAX groups: a batch they do not divide
        g = self.num_groups if x.shape[0] % self.num_groups == 0 else 1
        return g, self.sync

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rp = self.replicas
        world = 1 if rp is None else rp.data_world
        g, sync = self._scope(x)
        if self.training and sp.on(rp) and sp.is_sharded(x):
            return self._slab(x, g, sync)
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
        across = world > 1 and sync
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

    def _slab(self, x: torch.Tensor, g: int, sync: bool) -> torch.Tensor:
        """Train mode on this rank's depth slab: the statistics over the
        space group, and with ``sync`` over every rank."""
        rp = self.replicas
        sp.mark(self)
        y, mean, var, cnt = _SlabBatchNorm.apply(x, self.weight, self.bias,
                                                 g, *slab_scope(rp, sync),
                                                 self.eps)
        with torch.no_grad():
            upd = [mean.mean(dim=0),
                   (var * (cnt / max(cnt - 1, 1))).mean(dim=0)]
            if not sync:
                upd = rp.mean(upd)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(upd[0] * m)
            self.running_var.mul_(1 - m).add_(upd[1] * m)
            self.num_batches_tracked.add_(1)
        return y


class LayerNormVolume(nn.LayerNorm):
    def __init__(self, shape: Sequence[int]):
        super().__init__(tuple(shape), eps=1e-5)
        self.replicas = None    # parallel.Replicas, set by parallel.attach

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sdt = torch.promote_types(x.dtype, torch.float32)
        c = self.normalized_shape[0]
        rp = self.replicas
        if sp.on(rp) and sp.is_sharded(x):
            return self._slab(x, sdt, rp)
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

    def _slab(self, x: torch.Tensor, sdt: torch.dtype, rp) -> torch.Tensor:
        """This rank's depth slab of the whole input's LayerNorm."""
        xs = x.to(sdt)
        dims = tuple(range(1, x.dim()))
        shape = (-1,) + (1,) * len(dims)
        cnt = xs[0].numel() * rp.space
        # whole per-sample statistics that meet this rank's slab only
        mean = sp.allsum(xs.sum(dim=dims), rp) / cnt
        d = xs - mean.reshape(shape)
        var = sp.allsum(d.square().sum(dim=dims), rp) / cnt
        y = d * torch.rsqrt(var + self.eps).reshape(shape)
        lo, hi = sp.span(self.normalized_shape[1], rp)
        sp.mark(self)
        w, b = self.weight[:, lo:hi], self.bias[:, lo:hi]
        return (y * w.to(sdt) + b.to(sdt)).to(x.dtype)

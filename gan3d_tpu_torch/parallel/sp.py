"""Spatial parallelism over the space axis: the volume's depth sharded into
slabs, a halo exchange in every conv.

Counterpart of the JAX package's ("data", "space") mesh
(gan3d_tpu/parallel/mesh.py:16-45, gan3d_tpu/train/trainer.py:207-213),
where GSPMD partitions the step and inserts the halo exchanges; here every
rank of a space group (parallel/dist.py, ``Replicas.space``) runs the same
program on the same rows and on its slab of the depth, and calls the
collectives itself. Rank s of a space group of S holds planes [s * D/S,
(s + 1) * D/S) of every sharded activation [N, C, D, H, W]. The volumes
are cubes, so a tensor is a slab when its depth differs from its height
(``is_sharded``).

The rule (``shards``): a volume of side r is sharded while every rank
holds at least MIN_PLANES planes (r / S >= 2; the sides and S are powers
of two, so a slab starts on an even plane and no 2-window of a pool or an
upsample crosses it). Below that a layer runs on the gathered whole on
every rank and the result is split again where the next side allows
(``form``). The rule depends on S alone; at 64^3-256^3 that is:

- S = 2: every side from 4^3 up is sharded; only the 1^3 ends run whole
  (the DCGAN G's noise, the D's last conv output);
- S = 4: the 4^3 grid runs whole (BigGAN's first G block up to its
  upsample, its D's last stage after the downsample, the DCGAN G's stem
  and first BN, the DCGAN D's last conv); at 256^3 every other grid, 8^3
  to 256^3, is sharded, and the attention blocks (G at 32^3, D at 16^3)
  take 8 and 4 planes a rank;
- S = 8: the 4^3 and 8^3 grids run whole (also BigGAN's second G block
  and its D's last two stages, the DCGAN's 8^3 stages and its D's
  attention).

The collectives run over the space group, in the conjugate pairs of
parallel/tp.py (each backward the other's forward, so the gradient
penalty's double backward stays right), with the loss computed alike on
every rank of a space group. A slab's gradient is its slab's; a whole
value computed alike on every rank has the whole gradient on every rank:

- ``halo(x, before, after)``: the neighbours' edge planes around the
  slab (zeros at the volume's two ends, or the end plane repeated with
  ``edge``, as a clamped sample reads it); its backward adds the halo's
  gradient back onto the neighbours' edge planes (``_HaloT``);
- ``gather`` / ``split``: the whole depth from the slabs / this rank's
  slab of a whole value; backward the slab of the whole gradient / the
  gathered slabs' gradients;
- ``reduce``: the sum of per-slab parts into a whole value consumed alike
  on every rank (D's pooled sum, the gradient penalty's squared norm);
  backward the identity;
- ``allsum`` and ``gather_summed``: a whole value (statistics, the pooled
  keys and values of attention, the msl D's gathered input) that meets
  only this rank's slab, whose gradients are partial and summed over the
  space group.

A conv (``conv3d``) takes its depth halo and convolves with depth
padding 0: k3/s1/p1 takes a plane each side, the DCGAN D's k4/s2/p1 one
before and one after (from an even slab start), the DCGAN G's k4/s2/p1
transposed conv (``conv_transpose3d``) an input plane each side with its
output trimmed to twice the slab. The D's last conv (k4/s1/p0, 4^3 to
1^3) is a per-slab partial with the weight's depth slice, summed over
space. The knob routes (``wide_conv`` / ``fast_dw`` on) run K4 / K3 on the
halo'd slab with depth padding 1 and drop the two extra output planes;
their dW is the slab's (the dropped planes' gradient is zero). Where the
input is whole (below the rule), the layer runs on it alike on every rank;
a whole output computed from inputs that need no gradient (G's first
linear, the DCGAN G's stem, from the noise) is cut to the slab by a plain
slice (``cut``), which leaves those layers a partial gradient.

A parameter used on slabs has a partial gradient (``mark``; the convs,
BatchNorm's and LayerNorm's affine, attention's projections and gamma,
G's first linear, the DCGAN G's stem): ``reduce_grads`` sums those over
the space group and averages the others (computed alike on every rank,
such as D's last linear after the pooled sum; the mean makes them
bit-equal), before the data group's mean. The halo'd input a conv saves
is kept as the slab and its edge planes (``kept``), rebuilt when the
backward needs it.

Inside a remat group (nn/remat.py) ``kept`` stands aside: the
checkpoint's own saved-tensor hooks take whatever the group's layers
save and drop it, and the group keeps only its input, which is a slab
(its bytes on a rank are the slab's, not a halo'd copy's; were ``kept``
to pack there, each conv's slab and edge planes would stay saved through
the step beside the group's input, and remat would save nothing on
them). The group's recompute in backward runs its forward again on a
copy of the BN and spectral-norm state: every halo all-gather (and the
edge-plane fix of ``edge``) and every slab BatchNorm's statistics
all-reduce of the group, in the forward's order, on every rank of the
space group; attention stays outside the groups, so its gathers of the
pooled keys run once. Torch ends a recompute once it has the tensors
the backward needs, at the same op on every rank, since every rank runs
the same graph. The recompute's saved tensors (the halo'd slabs among
them) live until the group's backward ends.

Nothing here runs at import.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan3d_tpu_torch.ops import conv3d as conv_ops
from gan3d_tpu_torch.parallel import tp

MIN_PLANES = 2


def on(rp) -> bool:
    """Whether ``rp`` (a Replicas or None) has a space axis."""
    return rp is not None and rp.space > 1


def shards(side: int, rp) -> bool:
    """Whether a volume of ``side`` planes is depth-sharded (the rule)."""
    s = rp.space
    return s > 1 and side % s == 0 and side // s >= MIN_PLANES


def is_sharded(x: torch.Tensor) -> bool:
    """Whether ``x`` [N, C, D, H, W], a cube when whole, holds a slab."""
    return x.dim() == 5 and x.shape[2] != x.shape[3]


def span(side: int, rp) -> Tuple[int, int]:
    """[lo, hi) of this rank's slab of ``side`` planes."""
    k = side // rp.space
    return rp.space_rank * k, (rp.space_rank + 1) * k


def whole_shape(shape: Sequence[int], rp) -> tuple:
    """``shape`` of a volume (N, C, D, H, W) with its depth whole."""
    shape = tuple(shape)
    if on(rp) and len(shape) == 5 and shape[2] != shape[3]:
        return shape[:2] + (shape[2] * rp.space,) + shape[3:]
    return shape


# ---------------------------------------------------------------------------
# collectives over the space group (parallel/tp.py's conjugate pairs)
# ---------------------------------------------------------------------------
def gather(x: torch.Tensor, rp) -> torch.Tensor:
    """The whole depth, consumed alike on every rank."""
    return tp.gather(x, rp.space_axis, 2)


def split(x: torch.Tensor, rp) -> torch.Tensor:
    """This rank's slab of a whole value."""
    return tp.split(x, rp.space_axis, 2)


def reduce(x: torch.Tensor, rp) -> torch.Tensor:
    """The sum of per-slab parts, consumed alike on every rank."""
    return tp.reduce(x, rp.space_axis)


def allsum(x: torch.Tensor, rp) -> torch.Tensor:
    """The sum of per-slab parts, consumed on this rank's slab (its
    gradient summed over space)."""
    return tp.copy(tp.reduce(x, rp.space_axis), rp.space_axis)


def gather_summed(x: torch.Tensor, rp) -> torch.Tensor:
    """The whole depth, consumed on this rank's slab (its gradient summed
    over space, then sliced)."""
    return tp.copy(gather(x, rp), rp.space_axis)


def _edges(send_prev: Optional[torch.Tensor],
           send_next: Optional[torch.Tensor], like: torch.Tensor,
           n_prev: int, n_next: int, rp) -> tuple:
    """One exchange of edge planes with the neighbours: ``send_prev``
    goes to the previous rank, ``send_next`` to the next; returns (what
    the previous rank sent this one, what the next rank sent), zeros at
    the volume's ends (``n_prev`` / ``n_next`` planes shaped as ``like``)."""
    ax = rp.space_axis
    parts = [t for t in (send_prev, send_next) if t is not None]
    every = tp.all_gather(torch.cat(parts, 2).unsqueeze(0), 0, ax)
    a = 0 if send_prev is None else send_prev.shape[2]
    shape = list(like.shape)

    def zeros(k):
        shape[2] = k
        return like.new_zeros(shape)

    from_prev = zeros(n_prev)
    from_next = zeros(n_next)
    if n_prev and ax.rank > 0:
        from_prev = every[ax.rank - 1][:, :, a:a + n_prev]
    if n_next and ax.rank < ax.size - 1:
        from_next = every[ax.rank + 1][:, :, :n_next]
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    """[the previous slab's last ``before`` planes | x | the next slab's
    first ``after`` planes]."""

    @staticmethod
    def forward(ctx, rp, x, before, after):
        ctx.rp, ctx.before, ctx.after = rp, before, after
        tail = x[:, :, x.shape[2] - before:] if before else None
        head = x[:, :, :after] if after else None
        # my tail is the next rank's "before", my head the previous one's
        # "after"
        prev_tail, next_head = _edges(head, tail, x, before, after, rp)
        return torch.cat([prev_tail, x, next_head], 2)

    @staticmethod
    def backward(ctx, g):
        return None, _HaloT.apply(ctx.rp, g, ctx.before, ctx.after), \
            None, None


class _HaloT(torch.autograd.Function):
    """The adjoint of ``_Halo``: the middle planes, plus the gradients of
    the neighbours' halos added onto the edge planes they came from."""

    @staticmethod
    def forward(ctx, rp, g, before, after):
        ctx.rp, ctx.before, ctx.after = rp, before, after
        d = g.shape[2] - before - after
        out = g[:, :, before:before + d].clone()
        g_before = g[:, :, :before] if before else None  # the prev's tail
        g_after = g[:, :, before + d:] if after else None  # the next's head
        # the previous rank's g_after lands on my head, the next rank's
        # g_before on my tail
        from_prev, from_next = _edges(g_before, g_after, out, after, before,
                                      rp)
        if after:
            out[:, :, :after] += from_prev
        if before:
            out[:, :, d - before:] += from_next
        return out

    @staticmethod
    def backward(ctx, g):
        return None, _Halo.apply(ctx.rp, g, ctx.before, ctx.after), \
            None, None


def halo(x: torch.Tensor, before: int, after: int, rp,
         edge: bool = False) -> torch.Tensor:
    """The slab ``x`` with ``before`` planes of the previous slab and
    ``after`` of the next around it: zeros at the volume's ends, or with
    ``edge`` the end plane repeated (a sample clamped to the volume)."""
    if not before and not after:
        return x
    xh = _Halo.apply(rp, x, before, after)
    if edge:
        d, ax = xh.shape[2], rp.space_axis
        if before and ax.rank == 0:
            xh = torch.cat([x[:, :, :1].expand(-1, -1, before, -1, -1),
                            xh[:, :, before:]], 2)
        if after and ax.rank == ax.size - 1:
            xh = torch.cat([xh[:, :, :d - after],
                            x[:, :, -1:].expand(-1, -1, after, -1, -1)], 2)
    return xh


@contextlib.contextmanager
def kept(xh: torch.Tensor, x: torch.Tensor, before: int, after: int
         ) -> Iterator[None]:
    """Inside the block, whatever autograd saves that is ``xh`` (the slab
    ``x`` with its halo) is kept as ``x`` and the halo's planes, and
    rebuilt when the backward unpacks it (the hooks hold ``xh``'s address,
    not the tensor)."""
    if tp._REMAT_DEPTH[0] or xh is x:
        yield
        return
    ref = tp._layout_of(xh)
    d = x.shape[2]
    keep = (x.detach(), xh[:, :, :before].detach().clone(),
            xh[:, :, before + d:].detach().clone())

    def pack(t):
        return ("sp_halo", keep) if tp._layout_of(t) == ref else t

    def unpack(p):
        if isinstance(p, tuple) and p[0] == "sp_halo":
            mid, b, a = p[1]
            return torch.cat([b, mid, a], 2)
        return p

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield


# ---------------------------------------------------------------------------
# partial gradients
# ---------------------------------------------------------------------------
def mark(*params) -> None:
    """Mark parameters (or every parameter of modules) as used on slabs:
    ``reduce_grads`` sums their gradients over the space group. Only a
    forward that records gradients marks (under ``no_grad`` a whole value
    may be cut where a differentiated forward splits it)."""
    if not torch.is_grad_enabled():
        return
    for p in params:
        if isinstance(p, nn.Module):
            mark(*p.parameters())
        elif isinstance(p, nn.Parameter):
            p.sp_partial = True


def weight_leaf(layer: nn.Module) -> nn.Parameter:
    """The parameter behind ``layer.weight`` (a spectral norm's original)."""
    if hasattr(layer, "parametrizations"):
        return layer.parametrizations.weight.original
    return layer.weight


def reduce_grads(rp, params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Under a space axis, every gradient made whole and alike over the
    space group: summed where the parameter was used on slabs, else
    averaged (one all-reduce of a flat buffer); as they are otherwise."""
    if not on(rp):
        return list(grads)
    s = rp.space
    with torch.no_grad():
        flat = torch.cat([
            g.reshape(-1) if getattr(p, "sp_partial", False)
            else g.reshape(-1) / s for p, g in zip(params, grads)])
        flat = tp.all_sum(flat, rp.space_axis)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
    return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def form(x: torch.Tensor, rp) -> torch.Tensor:
    """``x`` as the rule wants it at its side: split where a whole value
    reaches a sharded side, gathered where a slab reaches a whole one."""
    if not on(rp) or x.dim() != 5:
        return x
    want, have = shards(x.shape[3], rp), is_sharded(x)
    if want and not have:
        return split(x, rp)
    if have and not want:
        return gather(x, rp)
    return x


def cut(y: torch.Tensor, rp, *layers: nn.Module) -> torch.Tensor:
    """This rank's slab of a whole ``y`` that ``layers`` computed alike
    on every rank from inputs that need no gradient, by a plain slice:
    their parameters then have a partial gradient. ``y`` as it is where
    its side is not sharded."""
    if not on(rp) or not shards(y.shape[3], rp) or is_sharded(y):
        return y
    lo, hi = span(y.shape[2], rp)
    mark(*layers)
    return y[:, :, lo:hi]


def _knob_route(xh: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the k3 conv kernels take this conv (ops/conv3d.conv3d's
    rule, on the halo'd slab at padding 1)."""
    return ((conv_ops.wide_conv_enabled() or conv_ops.fast_dw_enabled())
            and conv_ops.eligible(xh.shape, w.shape, 1, 1))


def conv3d(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Conv3d / SNConv3d (nn/layers.py) on ``x`` under a space axis."""
    rp = layer.replicas
    w = layer.weight.to(x.dtype)  # the spectral norm steps once
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    (k, kh, kw), (s, _, _), (p, ph, pw) = (layer.kernel_size, layer.stride,
                                           layer.padding)
    if not is_sharded(x):
        return form(conv_ops.conv3d(x, w, b, layer.stride, layer.padding),
                    rp)
    d = x.shape[2]
    if k - 2 * p == s and d % s == 0:  # windows aligned on the slabs
        before, after = p, k - p - s
        xh = halo(x, before, after, rp)
        mark(layer)
        with kept(xh, x, before, after):
            if (k, s, p, kh, kw, ph, pw) == (3, 1, 1, 3, 3, 1, 1) \
                    and _knob_route(xh, w):
                y = conv_ops.conv3d(xh, w, b, 1, 1)[:, :, 1:-1]
            else:
                y = conv_ops.conv3d(xh, w, b, layer.stride, (0, ph, pw))
        return form(y, rp)
    if p == 0 and k == x.shape[3]:  # the window spans the whole depth
        lo, hi = span(k, rp)
        mark(weight_leaf(layer))
        y = reduce(F.conv3d(x, w[:, :, lo:hi], None, layer.stride,
                            (0, ph, pw)), rp)
        return y if b is None else y + b.reshape(1, -1, 1, 1, 1)
    raise ValueError(f"no slab form for a conv with kernel {k}, stride "
                     f"{s}, padding {p} on a slab of {d} planes")


def conv_transpose3d(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A ConvTranspose3d (nn/layers.py) on ``x`` under a space axis."""
    rp = layer.replicas
    w = layer.weight.to(x.dtype)
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    (k, _, _), (s, _, _), (p, ph, pw) = (layer.kernel_size, layer.stride,
                                         layer.padding)
    if not is_sharded(x):
        y = F.conv_transpose3d(x, w, b, layer.stride, layer.padding)
        if not x.requires_grad:
            return cut(y, rp, layer)
        return form(y, rp)
    d = x.shape[2]
    # output plane o = s * i - p + t: the slab's outputs [s lo, s (lo + d))
    # take inputs lo - before .. lo + d - 1 + after
    before, after = -(-(k - 1 - p) // s), (s - 1 + p) // s
    xh = halo(x, before, after, rp)
    mark(layer)
    # the layer's own padding p trims p planes; drop s * before more from
    # the start and keep 2 s d (a larger depth padding, s * before + p,
    # trims it all in the conv, but the CPU's weight gradient of a
    # transposed conv padded that much came out wrong)
    start = s * before
    with kept(xh, x, before, after):
        y = F.conv_transpose3d(xh, w, b, layer.stride,
                               layer.padding)[:, :, start:start + s * d]
    return form(y, rp)


def global_sum_pool(x: torch.Tensor, rp) -> torch.Tensor:
    """Sum over D, H, W -> [N, C]; a slab's sum summed over space."""
    y = conv_ops.global_sum_pool(x)
    return reduce(y, rp) if on(rp) and is_sharded(x) else y

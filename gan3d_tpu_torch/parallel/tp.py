"""Tensor (channel) parallelism over the model axis: the wide layers'
weights hold their output channels' slice, and so do the activations
after them.

Counterpart of gan3d_tpu/parallel/tp.py, where GSPMD partitions the step
from sharding annotations; here every rank of a model group
(parallel/dist.py, ``Replicas.model``) runs the same program on the same
rows and calls the collectives itself.

The rule (``tp_shardings``, gan3d_tpu/parallel/tp.py:44-79): a parameter
is sharded when it has two dimensions or more, its output-channel
dimension splits into ``model`` slices of at least ``MIN_SHARD``, and it
does not belong to a self-attention block. In torch's layouts the output
channels are dimension 0 (Conv3d [O, I, k, k, k], Linear [O, I], the
LayerNorm affine [C, D, H, W], StyleGAN's modulated, FC and const
weights) and dimension 1 of a ConvTranspose3d [I, O, k, k, k]; a
spectral-normalized layer's ``parametrizations.weight.original`` follows
its layer. 1-D leaves stay whole on every rank: biases, BatchNorm's affine
and statistics, the spectral-norm vectors ``_u`` / ``_v``. The JAX rule
matches "attn" in the parameter's path, and the JAX DCGAN's attention is
auto-named ``SelfAttention3d_0``: the port follows that, sharding the
DCGAN attention's eligible projections (``SelfAttention3d.tp_replicated``
False there) and keeping BigGAN's ``attn{idx}`` whole.

The collectives run over the model group, with the loss computed alike on
every rank of it (Megatron-LM's conjugate pairs, each backward the
other's forward, so a double backward stays right):

- ``copy``: forward the identity, backward the sum over the group;
- ``reduce``: forward the sum, backward the identity;
- ``gather``: forward the channels' all-gather, backward this rank's
  slice;
- ``split``: forward this rank's slice, backward the all-gather.

A sharded layer (``run``) takes its whole input through ``copy`` (its
input gradient is a partial sum over the group), or a sharded input
through ``gather`` then ``copy``, and writes its slice of the outputs.
Every whole value that meets only this rank's slice goes through
``copy`` the same way: a sharded spectral norm's sigma, a LayerNorm's
statistics, StyleGAN's styles.
Where a layer's input was gathered, its saved input is this rank's slice
(``regathered``: autograd's saved-tensor hooks keep the slice and gather
it again when the backward needs it), so the gathered tensor lives only
from the gather to the layer's output. Inside a remat group
(nn/remat.py) the group recomputes instead, and its recompute gathers
again.

Activations (``Replicas.model`` > 1) stay sharded through the per-channel
ops after a sharded layer (bias, BatchNorm on its affine slice and its
statistics over the data group, LayerNorm with its statistics summed over
the model group, ReLU / LeakyReLU, up- and down-sampling) and are
gathered only where a consumer needs every channel: a replicated layer's
input, attention, G's skip slice, D's concatenated skip, a residual add
whose sides differ. Which form a tensor is in follows from its channel
count against the full one. Models whose ``tp_local_activations`` is
False (the StyleGAN families) gather each sharded layer's output at once.

A 1-D leaf that a rank uses only in its slice (a sharded layer's bias,
the affine of a BatchNorm on a sharded input) gets a gradient in that
slice only: ``reduce_grads`` sums those over the model group, averages
the other replicated leaves' (computed alike on every rank; the mean
makes them bit-equal), leaves each shard's own, then averages everything
over the data group. BatchNorm's running statistics are updated slice by
slice and gathered (``sync_buffers``) before a checkpoint or the replica
check. Checkpoints hold whole tensors in the reference's layout:
``full_state_dict`` gathers, ``load_full_state_dict`` slices.

The collectives are NCCL on the card and gloo on the CPU (gloo gathers
host tensors: a CUDA tensor goes through the host, as gloo would stage it
anyway). Nothing here runs at import.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils.parametrizations import _SpectralNorm

from gan3d_tpu_torch.parallel.dist import Axis

MIN_SHARD = 8


def on(rp) -> bool:
    """Whether ``rp`` (a Replicas or None) has a model axis."""
    return rp is not None and rp.model > 1


def span(rp, c: int) -> tuple:
    """[lo, hi) of this rank's slice of ``c`` channels."""
    k = c // rp.model
    return rp.model_rank * k, (rp.model_rank + 1) * k


# ---------------------------------------------------------------------------
# collectives over an inner axis of the grid (the model group here, the
# space group in parallel/sp.py): ``rp`` is a Replicas (its model axis)
# or a dist.Axis
# ---------------------------------------------------------------------------
def _axis(rp) -> Axis:
    return rp if isinstance(rp, Axis) else rp.model_axis


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def all_gather(x: torch.Tensor, dim: int, rp) -> torch.Tensor:
    """Every rank's ``x`` of the axis concatenated along ``dim`` in rank
    order (not differentiable)."""
    ax = _axis(rp)
    x = x.contiguous()
    if _nccl(ax.group):
        buf = x.new_empty((ax.size,) + tuple(x.shape))
        dist.all_gather_into_tensor(buf, x, group=ax.group)
        return torch.cat(buf.unbind(0), dim=dim)
    # gloo gathers host tensors (it would stage a CUDA one there anyway)
    host = x.cpu()
    parts = [torch.empty_like(host) for _ in range(ax.size)]
    dist.all_gather(parts, host, group=ax.group)
    return torch.cat(parts, dim=dim).to(x.device)


def all_sum(x: torch.Tensor, rp) -> torch.Tensor:
    """The sum of ``x`` over the axis (not differentiable)."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=_axis(rp).group)
    return y


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, _Reduce.apply(ctx.ax, g)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        ctx.ax = ax
        return all_sum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return None, _Copy.apply(ctx.ax, g)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x, dim):
        ctx.ax, ctx.dim = ax, dim
        return all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return None, _Split.apply(ctx.ax, g, ctx.dim), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x, dim):
        ctx.ax, ctx.dim = ax, dim
        k = x.shape[dim] // ax.size
        return x.narrow(dim, ax.rank * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return None, _Gather.apply(ctx.ax, g, ctx.dim), None


def copy(x: torch.Tensor, rp) -> torch.Tensor:
    return _Copy.apply(_axis(rp), x)


def reduce(x: torch.Tensor, rp) -> torch.Tensor:
    return _Reduce.apply(_axis(rp), x)


def gather(x: torch.Tensor, rp, dim: int = 1) -> torch.Tensor:
    return _Gather.apply(_axis(rp), x, dim)


def split(x: torch.Tensor, rp, dim: int = 1) -> torch.Tensor:
    return _Split.apply(_axis(rp), x, dim)


def layout(x: torch.Tensor, c: int, local: bool, rp) -> torch.Tensor:
    """``x`` (logically ``c`` channels on dim 1) as this rank's slice
    (``local``) or whole."""
    if local and x.shape[1] == c:
        return split(x, rp)
    if not local and x.shape[1] != c:
        return gather(x, rp)
    return x


def is_local(x: torch.Tensor, c: int) -> bool:
    """Whether ``x``, logically ``c`` channels, holds a slice of them."""
    return x.shape[1] != c


# ---------------------------------------------------------------------------
# the saved input of a layer that gathered it
# ---------------------------------------------------------------------------
_REMAT_DEPTH = [0]


@contextlib.contextmanager
def in_remat() -> Iterator[None]:
    """Marks a remat group's forward (nn/remat.py): its saved tensors are
    the group's to drop and recompute, so ``regathered`` stands aside."""
    _REMAT_DEPTH[0] += 1
    try:
        yield
    finally:
        _REMAT_DEPTH[0] -= 1


def _layout_of(t: torch.Tensor) -> tuple:
    return t.data_ptr(), tuple(t.shape), t.stride(), t.dtype


@contextlib.contextmanager
def regathered(full: torch.Tensor, local: torch.Tensor, rp
               ) -> Iterator[None]:
    """Inside the block, whatever autograd saves that is ``full`` (the
    gather of ``local``) is kept as ``local`` and gathered again when the
    backward unpacks it. The hooks hold ``full``'s address, not the
    tensor: autograd keeps them as long as what they packed."""
    if _REMAT_DEPTH[0]:
        yield
        return
    ref = _layout_of(full)
    keep = local.detach()

    def pack(t):
        return ("tp_local", keep) if _layout_of(t) == ref else t

    def unpack(p):
        if isinstance(p, tuple) and p[0] == "tp_local":
            return all_gather(p[1], 1, rp)
        return p

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _in_channels(layer: nn.Module) -> int:
    return (layer.in_features if isinstance(layer, nn.Linear)
            else layer.in_channels)


def sliced(p: Optional[torch.Tensor], lo: int, hi: int
           ) -> Optional[torch.Tensor]:
    """Rows [lo, hi) of a replicated 1-D leaf, which is then marked as
    used in its slice (``reduce_grads`` sums its gradient)."""
    if p is None:
        return None
    if isinstance(p, nn.Parameter):
        p.tp_sliced = True
    return p[lo:hi]


def run(layer: nn.Module, x: torch.Tensor,
        op: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
        ) -> torch.Tensor:
    """``op(input, bias)`` of a Conv3d / ConvTranspose3d / Linear on
    ``x`` under a model axis: a sharded layer (``layer.tp_span``) takes
    its whole input through ``copy`` and its bias slice and writes its
    output slice (gathered at once where ``layer.tp_gather_out``); a
    replicated one computes alike on every rank. A sharded input is
    gathered first and saved as its slice (``regathered``)."""
    rp = layer.replicas
    sp = getattr(layer, "tp_span", None)
    bias = layer.bias
    if sp is not None:
        bias = sliced(bias, *sp)
    if not is_local(x, _in_channels(layer)):
        y = op(copy(x, rp) if sp is not None else x, bias)
    else:
        full = gather(x, rp)
        with regathered(full, x, rp):
            y = op(copy(full, rp) if sp is not None else full, bias)
    if sp is not None and getattr(layer, "tp_gather_out", False):
        y = gather(y, rp)
    return y


class ShardedSpectralNorm(_SpectralNorm):
    """The spectral norm of a weight sharded on its output rows (W [O, K]
    as its rows [lo, hi) on each model rank), equal to one process's:
    ``u = normalize(W v)`` gathers the rows' products, ``v =
    normalize(W^T u)`` and ``sigma = u . (W v)`` sum the rows' parts over
    the group, sigma differentiably. ``_u`` [O] and ``_v`` [K] stay whole
    and alike on every rank. A layer's ``_SpectralNorm`` becomes one at
    ``shard``."""

    replicas: Any = None
    tp_span: tuple = (0, 0)

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        w = self._reshape_weight_to_matrix(weight)
        if self.training:
            self._power_method(w, self.n_power_iterations)
        u = self._u.clone(memory_format=torch.contiguous_format)
        v = self._v.clone(memory_format=torch.contiguous_format)
        lo, hi = self.tp_span
        return weight / sigma(u[lo:hi], w, v, self.replicas)

    @torch.no_grad()
    def _power_method(self, w: torch.Tensor, n: int) -> None:
        lo, hi = self.tp_span
        for _ in range(n):
            self._u.copy_(F.normalize(
                all_gather(torch.mv(w, self._v), 0, self.replicas), dim=0,
                eps=self.eps))
            self._v.copy_(F.normalize(
                all_sum(torch.mv(w.H, self._u[lo:hi]), self.replicas),
                dim=0, eps=self.eps))


def sigma(u_rows: torch.Tensor, w: torch.Tensor, v: torch.Tensor, rp
          ) -> torch.Tensor:
    """u . (W v) of the rows' parts, summed over the model group; it
    divides this rank's rows only, so its gradient is summed too
    (``copy``)."""
    return copy(reduce(torch.vdot(u_rows, torch.mv(w, v)).reshape(1), rp),
                rp)[0]


# ---------------------------------------------------------------------------
# the rule and the shards
# ---------------------------------------------------------------------------
def _out_dim(layer: nn.Module) -> int:
    return 1 if isinstance(layer, nn.ConvTranspose3d) else 0


def _owner(net: nn.Module, name: str):
    """(the layer a parameter belongs to, the module holding it, its
    attribute name)."""
    if name.endswith(".parametrizations.weight.original"):
        prefix = name[:-len(".parametrizations.weight.original")]
        layer = net.get_submodule(prefix)
        return layer, layer.parametrizations.weight, "original"
    prefix, _, attr = name.rpartition(".")
    mod = net.get_submodule(prefix) if prefix else net
    return mod, mod, attr


def plan(net: nn.Module, model: int, min_shard: int = MIN_SHARD
         ) -> Dict[str, int]:
    """{parameter name: its output-channel dim} of the parameters of
    ``net`` the rule shards over ``model`` ranks (module docstring)."""
    from gan3d_tpu_torch.nn.attention import SelfAttention3d

    whole = [n + "." for n, m in net.named_modules()
             if isinstance(m, SelfAttention3d) and m.tp_replicated]
    out = {}
    for name, p in net.named_parameters():
        if p.ndim < 2 or any(name.startswith(w) for w in whole):
            continue
        dim = _out_dim(_owner(net, name)[0])
        size = p.shape[dim]
        if size % model == 0 and size // model >= min_shard:
            out[name] = dim
    return out


def shard(net: nn.Module, rp) -> Dict[str, int]:
    """Keep this rank's slice of every parameter ``plan`` shards (the net
    built whole from the seed on every rank, so the slices are one
    process's); a sharded spectral norm becomes ``ShardedSpectralNorm``.
    Returns the plan, which ``net.tp_plan`` keeps."""
    sharded = plan(net, rp.model)
    local_acts = getattr(net, "tp_local_activations", False)
    for name, dim in sharded.items():
        layer, holder, attr = _owner(net, name)
        p = getattr(holder, attr)
        k = p.shape[dim] // rp.model
        lo = rp.model_rank * k
        new = nn.Parameter(p.detach().narrow(dim, lo, k).clone())
        new.tp_dim = dim
        setattr(holder, attr, new)
        layer.tp_span = (lo, lo + k)
        layer.tp_gather_out = not local_acts
        if holder is not layer:  # the spectral norm of a sharded weight
            sn = holder[0]
            sn.__class__ = ShardedSpectralNorm
            sn.replicas, sn.tp_span = rp, (lo, lo + k)
    net.tp_plan = sharded
    return sharded


def sharded(p: torch.Tensor) -> bool:
    return hasattr(p, "tp_dim")


def reduce_grads(rp, params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients Adam applies: under a model axis, the replicated
    leaves' made whole and alike over the model group (summed where used
    in slices, else averaged), then everything averaged over the data
    group (``Replicas.mean``)."""
    if not on(rp):
        return rp.mean(grads)
    grads = list(grads)
    rep = [i for i, p in enumerate(params) if not sharded(p)]
    with torch.no_grad():
        parts = [grads[i].reshape(-1) if getattr(params[i], "tp_sliced",
                                                 False)
                 else grads[i].reshape(-1) / rp.model for i in rep]
        flat = all_sum(torch.cat(parts), rp) if parts else None
        at = 0
        for i in rep:
            n = grads[i].numel()
            grads[i] = flat[at:at + n].view_as(grads[i])
            at += n
    return rp.mean(grads)


def sync_buffers(net: nn.Module, rp) -> None:
    """Gather the slices of the running statistics that BatchNorms on
    sharded inputs updated (``tp_span``), so every rank holds them
    whole."""
    if not on(rp):
        return
    from gan3d_tpu_torch.nn.norm import BatchNorm3d

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm3d) and getattr(m, "tp_span", None):
                lo, hi = m.tp_span
                for buf in (m.running_mean, m.running_var):
                    buf.copy_(all_gather(buf[lo:hi], 0, rp))


def full_state_dict(net: nn.Module, rp) -> Dict[str, torch.Tensor]:
    """``net.state_dict()`` with every shard gathered whole and the
    running statistics synced: the one-process state_dict, on every
    rank."""
    sync_buffers(net, rp)
    sd = net.state_dict()
    for name, dim in getattr(net, "tp_plan", {}).items():
        sd[name] = all_gather(sd[name], dim, rp)
    return sd


def load_full_state_dict(net: nn.Module, sd: Dict[str, torch.Tensor],
                         rp) -> None:
    """Load a one-process state_dict into a sharded ``net``: each shard
    takes its slice."""
    sd = dict(sd)
    for name, dim in getattr(net, "tp_plan", {}).items():
        k = sd[name].shape[dim] // rp.model
        sd[name] = sd[name].narrow(dim, rp.model_rank * k, k)
    net.load_state_dict(sd)


def full_moments(params: Sequence[torch.Tensor],
                 moments: Sequence[torch.Tensor], rp) -> List[torch.Tensor]:
    """Adam's moments (aligned with ``params``) with the shards' gathered."""
    return [all_gather(m, p.tp_dim, rp) if sharded(p) else m
            for p, m in zip(params, moments)]


def local_moments(params: Sequence[torch.Tensor],
                  moments: Sequence[torch.Tensor], rp) -> List[torch.Tensor]:
    """Whole moments cut to this rank's slices."""
    out = []
    for p, m in zip(params, moments):
        if sharded(p):
            k = m.shape[p.tp_dim] // rp.model
            m = m.narrow(p.tp_dim, rp.model_rank * k, k)
        out.append(m)
    return out

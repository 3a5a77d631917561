"""Data, tensor and spatial parallelism over processes: one rank a card, or
N gloo ranks on the CPU.

Counterpart of gan3d_tpu/parallel/mesh.py:22-93 for its 1-D ``data`` mesh
(``make_mesh``, ``init_distributed``, ``put_global_batch``). The JAX
package shards the batch over the mesh, replicates the parameters and lets
XLA insert the gradient all-reduce; here every rank is a process that
holds a full replica, takes its rows of the global batch, and calls the
collectives itself:

- ``plan`` resolves how many ranks a run takes: ``num_devices`` ranks in
  all, 0 = every visible card (on the CPU, one process), over
  ``num_processes`` hosts with ``distributed``; more cards than a host
  shows raises;
- ``launch`` starts a host's ranks (``spawn``), each pinned to its card,
  with a rendezvous (a ``file://`` in a fresh temporary directory on one
  host, ``tcp://coordinator_address`` across hosts) and a timeout on
  every collective; it waits for them and returns rank 0's result. One
  rank that fails stops the others and the run;
- ``Replicas`` is a rank's place in the run and its collectives: its rows
  of a global batch, the differentiable sum and gather that BatchNorm's
  cross-replica statistics and the minibatch-std layer use, the mean of a
  list of tensors in one flat buffer (the step's gradients, its logged
  losses), and the replica check (every replicated parameter and buffer
  bit-equal to rank 0's, every shard to its data group's first rank's).

The rank grid (``model_devices`` or ``spatial_devices``, the JAX
``make_mesh``'s model or space axis, gan3d_tpu/parallel/mesh.py:16-45):
world = data x inner ranks, adjacent ranks sharing an inner group, rank =
d * inner + i, where the inner axis is the model axis (``model`` ranks,
``model_rank``) or the space axis (``space`` ranks, ``space_rank``), never
both. The ranks of an inner group take the same rows: a model group holds
slices of the wide layers' channels (parallel/tp.py), a space group slabs
of the volume's depth (parallel/sp.py); the ranks of a data group hold the
same slices of different rows. Rows, the minibatch-std gather and the
gradient mean run over the data group (``data_world`` ranks, this one
``data_rank``), the channel gathers and sums of parallel/tp.py over the
model group, the halo exchanges and depth gathers of parallel/sp.py over
the space group (``Axis``: a group, its size, this rank's place in it);
``rank`` and ``world`` count every rank.

NCCL runs the collectives on the card and gloo on the CPU. A rank of
``world == 1`` with a group still all-reduces its gradients (a mean over
one rank, exact); ``ONE`` is the one-process run, with no group and no
collective. Nothing here touches CUDA or a process group at import time.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=600)  # a collective's longest wait
RESULT_FILE = "rank0_result.pt"


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks; its backward is the sum of the gradients over
    ranks (differentiable again, for a double backward)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return None, _AllReduceSum.apply(ctx.group, g)


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` concatenated along dim 0 in rank order, as the
    sum of each rank's rows placed in zeros (exact; an all-reduce, which
    gloo also runs on CUDA tensors, where it has no all-gather); the
    backward sums the gradient of the whole over ranks and keeps this
    rank's rows."""

    @staticmethod
    def forward(ctx, group, world, rank, x):
        ctx.group, ctx.world, ctx.rank = group, world, rank
        n = x.shape[0]
        out = x.new_zeros((world * n,) + tuple(x.shape[1:]))
        out[rank * n:(rank + 1) * n] = x
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        full = _AllReduceSum.apply(ctx.group, g)
        n = full.shape[0] // ctx.world
        return None, None, None, full[ctx.rank * n:(ctx.rank + 1) * n]


@dataclass(frozen=True)
class Axis:
    """An inner axis of the grid as its collectives see it: the process
    group of this rank's model or space group, its ``size`` and this
    rank's place in it."""

    group: Any
    size: int
    rank: int


@dataclass(frozen=True)
class Replicas:
    """Rank ``rank`` of ``world``, the ``local_rank``-th of the
    ``local_world`` ranks of its host, on ``device``; ``group`` is None in
    the one-process run."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None
    model: int = 1          # ranks of a model group
    data_group: Any = None  # with an inner axis: this one's slice's ranks
    model_group: Any = None  # with model > 1: the ranks of this one's rows
    space: int = 1          # ranks of a space group
    space_group: Any = None  # with space > 1: the ranks of this one's rows

    def __deepcopy__(self, memo):  # models carry it; a copy shares it
        return self

    @property
    def main(self) -> bool:
        """Rank 0: the rank that prints and writes."""
        return self.rank == 0

    @property
    def host(self) -> int:
        return self.rank // self.local_world

    @property
    def inner(self) -> int:
        """The ranks that share a row set: a model or a space group."""
        return self.model * self.space

    @property
    def data_world(self) -> int:
        """The ranks that split the batch."""
        return self.world // self.inner

    @property
    def data_rank(self) -> int:
        return self.rank // self.inner

    @property
    def model_rank(self) -> int:
        """This rank's place in its model group: which slice it holds."""
        return self.rank % self.model

    @property
    def space_rank(self) -> int:
        """This rank's place in its space group: which depth slab it
        holds."""
        return self.rank % self.space

    @property
    def model_axis(self) -> Axis:
        return Axis(self.model_group, self.model, self.model_rank)

    @property
    def space_axis(self) -> Axis:
        return Axis(self.space_group, self.space, self.space_rank)

    @property
    def dgroup(self) -> Any:
        """The process group of the data group (None: no collective)."""
        return self.group if self.inner == 1 else self.data_group

    def span(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this rank's rows of a global batch of ``n``."""
        if n % self.data_world:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.data_world} ranks")
        b = n // self.data_world
        return self.data_rank * b, (self.data_rank + 1) * b

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global batch ``x``."""
        if self.data_world == 1:
            return x
        lo, hi = self.span(x.shape[0])
        return x[lo:hi]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data group, differentiable."""
        if self.data_world == 1:
            return x
        return _AllReduceSum.apply(self.dgroup, x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows in rank order, differentiable."""
        if self.data_world == 1:
            return x
        return _AllGather.apply(self.dgroup, self.data_world,
                                self.data_rank, x)

    def mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the data group of each of ``tensors`` (one
        dtype), through one all-reduce of a flat buffer; not
        differentiable. The one-process run, and a data group of one
        rank beside a model axis, return them as they are."""
        if self.dgroup is None:
            return list(tensors)
        if len({t.dtype for t in tensors}) > 1:
            raise ValueError("Replicas.mean takes tensors of one dtype")
        with torch.no_grad():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.all_reduce(flat, group=self.dgroup)
            flat.div_(self.data_world)
            out, at = [], 0
            for t in tensors:
                out.append(flat[at:at + t.numel()].view_as(t))
                at += t.numel()
        return out

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def agree(self, value: bool) -> bool:
        """Rank 0's ``value`` on every rank."""
        if self.group is None:
            return value
        t = torch.tensor([float(value)], device=self.device)
        dist.broadcast(t, 0, group=self.group)
        return bool(t.item())

    def check(self, tensors: Iterable[torch.Tensor],
              shards: Iterable[torch.Tensor] = ()) -> int:
        """The replica check: rank 0's ``tensors`` (a model's replicated
        parameters and buffers) broadcast, each rank's compared with them
        bit for bit, and the same for ``shards`` (the sharded ones) within
        each data group, against its first rank's; raises on every rank
        when any rank differs. Returns the number of tensors compared."""
        tensors = [t.detach() for t in tensors]
        shards = [t.detach() for t in shards]
        bad = _differ(tensors, 0, self.group)
        if shards:
            bad += _differ(shards, self.model_rank, self.data_group)
        total = torch.tensor([float(bad)], device=self.device)
        if self.group is not None:
            dist.all_reduce(total, group=self.group)
        if total.item():
            raise RuntimeError(
                f"replica check: {int(total.item())} tensors differ from "
                f"rank 0's ({bad} on rank {self.rank})")
        return len(tensors) + len(shards)


def _differ(tensors: List[torch.Tensor], src: int, group: Any) -> int:
    """How many of ``tensors`` differ, bit for bit, from global rank
    ``src``'s, broadcast over ``group`` (None: nothing to compare)."""
    bad = 0
    # one order on every rank (a set's would follow the dtypes' ids)
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        mine = [t for t in tensors if t.dtype == dtype]
        ref = torch.cat([t.reshape(-1) for t in mine])
        if group is not None:
            dist.broadcast(ref, src, group=group)
        for t, r in zip(mine, ref.split([t.numel() for t in mine])):
            # bit for bit (a nan equals its own bits, -0 is not +0)
            bad += not torch.equal(
                r.contiguous().view(torch.uint8),
                t.reshape(-1).contiguous().view(torch.uint8))
    return bad


ONE = Replicas()


def attach(module: torch.nn.Module, replicas: Replicas) -> None:
    """Give every submodule that reads a ``replicas`` attribute (BatchNorm,
    the minibatch-std layer, the synthesis' noise, StyleGAN-1's mixing,
    the msl crops) this rank's place."""
    for m in module.modules():
        if hasattr(m, "replicas"):
            m.replicas = replicas


@dataclass(frozen=True)
class Plan:
    """The ranks of a run: ``world`` in all, ``local`` started on this
    host, the first of them global rank ``first``, on ``device`` ("cuda"
    or "cpu"); ``coordinator`` is host:port across hosts, else "";
    ``model`` ranks a model group, ``space`` ranks a space group."""

    world: int
    local: int
    first: int
    device: str
    coordinator: str = ""
    model: int = 1
    space: int = 1

    @property
    def parallel(self) -> bool:
        """Whether the run takes a process group (more than one rank, or
        several hosts)."""
        return self.world > 1 or bool(self.coordinator)


def plan(num_devices: int, platform: str = "", distributed: bool = False,
         coordinator_address: str = "", num_processes: int = 0,
         process_id: int = -1, device: Optional[str] = None,
         model_devices: int = 1, spatial_devices: int = 1) -> Plan:
    """The ranks ``num_devices`` asks for (JAX: ``make_mesh``'s device
    count, 0 = every device) on ``platform`` (or the resolved ``device``
    type). On the card a rank is a card: 0 takes every visible card of
    each host, and more than a host shows raises. On the CPU
    ``num_devices`` gloo ranks run (0 = one a host). With ``distributed``
    the ranks spread evenly over ``num_processes`` hosts, this one
    ``process_id``, meeting at ``coordinator_address``. ``model_devices``
    ranks form a model group, ``spatial_devices`` ranks a space group
    (either on one host); as ``make_mesh``, the two together raise, and
    so does a world the group does not divide."""
    if spatial_devices > 1 and model_devices > 1:
        raise ValueError("spatial and model parallelism cannot be combined "
                         "yet — pick one of spatial_devices/model_devices")
    if model_devices < 1 or spatial_devices < 1:
        raise ValueError(f"model_devices={model_devices} or spatial_devices"
                         f"={spatial_devices} is below 1")
    inner = model_devices * spatial_devices
    if device is None:
        from gan3d_tpu_torch.utils.platform import resolve_device

        device = resolve_device(platform).type
    if num_devices < 0:
        raise ValueError(f"num_devices={num_devices} is negative")
    hosts, host = 1, 0
    if distributed:
        if not coordinator_address or num_processes < 1 \
                or not 0 <= process_id < num_processes:
            raise ValueError(
                "distributed=True needs coordinator_address (host:port), "
                "num_processes >= 1 and 0 <= process_id < num_processes; "
                f"got {coordinator_address!r}, {num_processes}, "
                f"{process_id}")
        hosts, host = num_processes, process_id
    if num_devices == 0:
        local = max(torch.cuda.device_count(), 1) if device == "cuda" else 1
    else:
        if num_devices % hosts:
            raise ValueError(f"num_devices={num_devices} does not split "
                             f"over {hosts} hosts")
        local = num_devices // hosts
    if device == "cuda" and num_devices and local > torch.cuda.device_count():
        raise ValueError(
            f"num_devices={num_devices} asks {local} cards a host; "
            f"{torch.cuda.device_count()} are visible")
    world = local * hosts
    if world % inner or local % inner:
        kind = "model" if model_devices > 1 else "space"
        raise ValueError(
            f"{world} devices not divisible by {inner}"
            + ("" if world % inner else
               f" on each host ({local} a host): a {kind} group spans one "
               "host"))
    return Plan(world=world, local=local, first=host * local,
                device=device,
                coordinator=coordinator_address if distributed else "",
                model=model_devices, space=spatial_devices)


def plan_for(cfg, device: Optional[str] = None) -> Plan:
    """``plan`` of a training Config; as the JAX trainer
    (gan3d_tpu/train/trainer.py:140-143), a resolution that
    ``spatial_devices`` does not divide raises."""
    if cfg.spatial_devices > 1 and cfg.resolution % cfg.spatial_devices:
        raise ValueError(
            f"resolution {cfg.resolution} not divisible by "
            f"spatial_devices {cfg.spatial_devices}")
    return plan(cfg.num_devices, cfg.platform, cfg.distributed,
                cfg.coordinator_address, cfg.num_processes, cfg.process_id,
                device, cfg.model_devices, cfg.spatial_devices)


def grid(rank: int, world: int, local_rank: int, local_world: int,
         device: torch.device, model: int = 1, space: int = 1) -> Replicas:
    """This rank's ``Replicas`` in the joined default process group, with
    its data group and its model group (``model`` > 1) or space group
    (``space`` > 1); every rank makes every group, in one order, as
    ``new_group`` requires."""
    if model > 1 and space > 1:
        raise ValueError("spatial and model parallelism cannot be combined "
                         "yet — pick one of spatial_devices/model_devices")
    inner = model * space
    if world % inner:
        raise ValueError(f"{world} devices not divisible by {inner}")
    data_group = inner_group = None
    if inner > 1:
        for i in range(inner):  # ranks i, i + inner, ...: one slice each
            ranks = list(range(i, world, inner))
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank % inner == i:
                data_group = g
        for d in range(world // inner):  # adjacent ranks: one row set
            g = dist.new_group(list(range(d * inner, (d + 1) * inner)))
            if rank // inner == d:
                inner_group = g
    return Replicas(rank=rank, world=world, local_rank=local_rank,
                    local_world=local_world, device=device,
                    group=dist.group.WORLD, model=model,
                    data_group=data_group,
                    model_group=inner_group if model > 1 else None,
                    space=space,
                    space_group=inner_group if space > 1 else None)


def init(rank: int, world: int, init_method: str, local_rank: int,
         local_world: int, device: torch.device,
         timeout: datetime.timedelta = TIMEOUT, model: int = 1,
         space: int = 1) -> Replicas:
    """Join the process group as ``rank`` of ``world``: NCCL with the rank
    pinned to ``device`` on the card, gloo on the CPU; ``model`` ranks a
    model group, ``space`` ranks a space group (``grid``)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=init_method, rank=rank,
                                world_size=world, timeout=timeout,
                                device_id=device)
    else:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world, timeout=timeout)
    return grid(rank, world, local_rank, local_world, device, model, space)


def _entry(local_rank: int, fn: Callable, args: tuple, p: Plan,
           init_method: str, out_dir: str) -> None:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    if p.device == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        # the host's cores shared among its ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // p.local))
    device = (torch.device("cuda", local_rank) if p.device == "cuda"
              else torch.device("cpu"))
    rp = init(p.first + local_rank, p.world, init_method, local_rank,
              p.local, device, model=p.model, space=p.space)
    try:
        result = fn(rp, *args)
        if rp.main:
            torch.save(result, os.path.join(out_dir, RESULT_FILE))
        # no rank leaves (and tears the group down) while a peer still
        # uses it
        rp.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable[..., Any], args: tuple, p: Plan,
           timeout: Optional[float] = None) -> Any:
    """Run ``fn(replicas, *args)`` on this host's ``p.local`` ranks, one
    spawned process each, and wait for them; returns rank 0's result
    (None on the other hosts). ``fn`` must be importable by name. Any
    rank's exception stops the others and is raised here, as is running
    past ``timeout`` seconds."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="gan3d_dp_")
    init_method = (f"tcp://{p.coordinator}" if p.coordinator
                   else "file://" + os.path.join(tmp, "rendezvous"))
    try:
        ctx = mp.start_processes(_entry, args=(fn, args, p, init_method, tmp),
                                 nprocs=p.local, join=False,
                                 start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
                for proc in ctx.processes:
                    proc.join()
                raise TimeoutError(f"{p.local} ranks still running after "
                                   f"{timeout} s")
        path = os.path.join(tmp, RESULT_FILE)
        if not os.path.isfile(path):
            return None
        return torch.load(path, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

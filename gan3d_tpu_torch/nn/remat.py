"""Activation rematerialization that steps the spectral-norm and BN state
once.

Counterpart of flax's lifted ``nn.remat`` as the JAX package uses it
(``cfg.remat``: gan3d_tpu/models/biggan.py:72-74, 97-129, 150-186,
models/stylegan/generator.py:140, discriminator.py:139): a group of
modules runs its forward without keeping its activations, and recomputes
them in backward.

``torch.utils.checkpoint`` alone would re-run the group's forward in
backward as it is, which (a) steps every spectral-norm power iteration and
BN running stat of the group a second time, and (b) recomputes from the
vectors the first pass left, not the ones it saw, so the gradient would
differ from the JAX one. Here:

- the first pass runs on the modules themselves and steps their state
  once, as without remat;
- at entry the group's state is copied: the buffers of its BN and
  spectral-norm modules (running stats, ``_u`` / ``_v``; a few KB). Every
  recompute runs on fresh clones of that copy, swapped in for the
  modules' own buffers, so it sees exactly what the first pass saw, and
  what it writes is dropped. D's vectors step again between a forward and
  its backward (D(real), then D(fake), then the gradient): the copy keeps
  the recompute off them.

The checkpoint is non-reentrant, so a group can be differentiated twice
(the gradient penalty, R1, and the path-length penalty with
``sg2_reg_grads``). Nothing inside a group draws random numbers: callers
pass noise in. Under ``torch.no_grad`` a group runs as it is. Remat never
wraps a module: models apply it in ``forward``, so state_dict keys do not
change.

Under a model axis (parallel/tp.py) a group's recompute gathers the
channels again, in the same order on every rank of the model group.

``nested`` is the port's stage group: one checkpoint over a stage whose
recompute checkpoints each block again, so backward holds one stage's
block boundaries and one block's activations at a time, never a whole
stage's. The values are those of one group; the cost is a third forward
of each block but the stage's last (torch's recompute stops once it has
that block's input).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Sequence, Tuple

import torch
import torch.nn as nn
from torch.nn.utils.parametrizations import _SpectralNorm
from torch.utils.checkpoint import checkpoint as _checkpoint

from gan3d_tpu_torch.parallel import tp

SCOPES = ("block", "stage")
# the modules whose train-mode forward writes their buffers
_STATEFUL = (nn.modules.batchnorm._BatchNorm, _SpectralNorm)

State = List[Tuple[nn.Module, str, torch.Tensor]]


def scope(enabled: bool, name: str) -> str:
    """"" when remat is off, else ``name`` ("block" or "stage"); a name
    outside SCOPES raises either way."""
    if name not in SCOPES:
        raise ValueError(f"remat_scope {name!r} not in {SCOPES}")
    return name if enabled else ""


def group_state(modules: Sequence[nn.Module]) -> State:
    """(module, buffer name, a copy) of every buffer of the BN and
    spectral-norm modules in ``modules``."""
    return [(m, name, buf.detach().clone())
            for mod in modules for m in mod.modules()
            if isinstance(m, _STATEFUL)
            for name, buf in m._buffers.items() if buf is not None]


@contextlib.contextmanager
def swapped(state: State) -> Iterator[None]:
    """Inside the block the modules run on clones of ``state``."""
    own = [(m, name, m._buffers[name]) for m, name, _ in state]
    for m, name, copy in state:
        m._buffers[name] = copy.clone()
    try:
        yield
    finally:
        for m, name, buf in own:
            m._buffers[name] = buf


def checkpoint(fn: Callable, modules: Sequence[nn.Module], *args):
    """``fn(*args)``, its activations recomputed in backward; the BN and
    spectral-norm state of ``modules`` (everything ``fn`` runs) steps once
    and every recompute starts from the state the first pass found."""
    if not torch.is_grad_enabled():
        return fn(*args)
    state = group_state(modules)
    first = [True]

    def run(*a):
        # the group's saved tensors are the checkpoint's (parallel/tp.py)
        with tp.in_remat():
            if first[0]:
                first[0] = False
                return fn(*a)
            with swapped(state):
                return fn(*a)

    return _checkpoint(run, *args, use_reentrant=False,
                       preserve_rng_state=False)


def sequential(layers: Sequence[Callable], x: torch.Tensor,
               remat: bool = True) -> torch.Tensor:
    """``x`` through ``layers`` in order; one checkpointed group when
    ``remat``."""
    def run(h: torch.Tensor) -> torch.Tensor:
        for f in layers:
            h = f(h)
        return h

    if not remat:
        return run(x)
    return checkpoint(run, [f for f in layers if isinstance(f, nn.Module)],
                      x)


def nested(groups: Sequence[Sequence[Callable]],
           x: torch.Tensor) -> torch.Tensor:
    """``x`` through ``groups`` in order as one checkpointed group, each of
    ``groups`` a checkpointed group inside it (``sequential``)."""
    def run(h: torch.Tensor) -> torch.Tensor:
        for layers in groups:
            h = sequential(layers, h)
        return h

    return checkpoint(run, [f for layers in groups for f in layers
                            if isinstance(f, nn.Module)], x)

"""Spatial parallelism (gan3d_tpu_torch/parallel/sp.py) on the CPU: gloo
ranks holding depth slabs against the JAX package (its plain ops, its
modules, and its ("data", "space") mesh on the virtual CPU devices of
tests/conftest.py) and against the port's one-process run.

One spawn for the module: the fixture ``ranks`` builds every case's
inputs from seeds (numpy, and the JAX modules' variable trees through
``jax.eval_shape`` and a numpy fill, converted with ``convert``), starts
four gloo ranks (``parallel.launch``, the train CLI's launcher; joined
within 120 s) that run the port's side of every case, and meanwhile runs
the JAX side in worker threads and the one-process steps here. The ranks
form data 2 x space 2 (``dist.grid``) and, over the same processes, one
space group of 4; a case at S = 2 reads the first data row's two ranks.
Each case is then asserted in its own test. Cases and tolerances (f32):

- the halo conv (k3/s1/p1), the DCGAN D's k4/s2/p1 conv and the DCGAN
  G's k4/s2/p1 transposed conv at S = 2 and 4 against the JAX
  ``conv3d`` / ``conv_transpose3d`` on the same inputs: the gathered
  output, the input gradient (gathered) and the weight and bias
  gradients (summed over the ranks) of sum(y * r), 1e-5 of the largest
  value; at S = 4 the k4/s2/p1 conv's 8^3 output is two planes a rank;
- the knob routes: with ``wide_conv`` and ``fast_dw`` on, the k3 conv on
  slabs goes through ``WideConv3d`` on the halo'd slab at padding 1
  (their plain versions here), the same to 1e-5;
- the attention block on slabs (S = 2, 16^3, gamma 0.7) against the JAX
  ``SelfAttention3d`` with its attention lowered through XLA (as
  tests/test_spatial.py runs it on the mesh): output, input gradient and
  parameter gradients, and the spectral-norm vectors after the forward,
  TOL of test_torch_layers.py;
- BatchNorm on slabs at data 2 x space 2 with ``sync`` (the JAX
  ``BatchNorm3d`` over the global batch) and without it (the JAX groups
  of ``_bn_groups``: a group a device, ``num_groups=4``), and a model
  axis without ``sync`` (the repair: ``num_groups=2`` at model 2, in
  this process); LayerNormVolume on slabs against the JAX module: the
  output, input, scale and bias gradients and the running stats, TOL;
- the slice against the JAX mesh: BigGAN G's train-mode forward and D's
  forward and hinge-loss gradient at 16^3, filters 8, batch 4, on the
  port's data 2 x space 2 and on the JAX ``make_mesh(4, spatial=2)``
  (inputs sharded ``P("data", "space")``, G's output sharded alike,
  attention through XLA), with the same weights: G's output to 1e-4 of
  its largest, D's outputs and the loss to 1e-5, each gradient to 1e-5
  of the largest gradient; the same with ``remat=True``,
  ``remat_scope="stage"`` on both sides (the port's G run with gradients
  on, so its groups checkpoint; each group's recompute exchanges again),
  where every group's input on a rank is a slab and ``sp.kept`` packs
  nothing inside a group (the checkpoint's hooks take those tensors);
- two training steps at data 2 x space 2 against the port's one process
  on the global batch (held to JAX by test_torch_step.py), same seed and
  generator, for the flagship's flags, with ``remat`` per stage and per
  block and with ``fused_step=False``, ``--dcgan`` (LayerNorm D),
  ``--msl``, the hybrid and ``--dcgan --gp_weight=10`` (the double
  backward through every halo), and the flagship at S = 4, where the 4^3
  grid runs whole (the layer rule for thin grids; its forms read by
  forward hooks): step 0 by test_torch_tp.check_like_one_process (losses
  1e-5, each gradient within 1e-5 of its update's largest and 1e-4 of
  its own or 3x the step's own spread, parameters, BN and SN state), with
  the floor of a one-process step with BN's statistics in another order
  (chip_smoke.bn_formula); step 1's losses to 1e-3 (the dp phase's
  DP_TOL); every rank's state bit-equal;
- a checkpoint written at data 2 x space 2 resumed at S = 4 and in one
  process: both print the resume, and their next step's losses agree to
  1e-4;
- the slab BatchNorm a chunk of rows at a time against one chunk and
  against torch's BatchNorm (one rank; the collective the identity);
- without compute, the 256^3 configs at S = 4 (filters 64, 8 and 4):
  every grid from 8^3 up is a slab and 4^3 runs whole, and each attention
  placement's query slab (L / 4, M, c) is one the K1/K2 wrapper admits,
  but for filters 4's c = 4;
- the raises: a resolution the space axis does not divide, spatial with
  model parallelism; the StyleGAN families, which train under the space
  axis (test_torch_spatial_stylegan.py), refused in one process without a
  process group as the other families are.

Budget: under 50 s on one worker (the spawn and the JAX compiles
overlap).
"""

import contextlib
import copy
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gan3d_tpu_torch import convert
from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models import build_models
from gan3d_tpu_torch.nn import SelfAttention3d, remat
from gan3d_tpu_torch.nn.layers import Conv3d, ConvTranspose3d
from gan3d_tpu_torch.nn.norm import BatchNorm3d, LayerNormVolume
from gan3d_tpu_torch.ops import conv3d as conv_ops
from gan3d_tpu_torch.ops import cuda_attention
from gan3d_tpu_torch.parallel import dist, sp
from gan3d_tpu_torch.train.step import reduce_grads, train_step

from test_torch_dp import BASE, RecAdam, reals_for, summary
from test_torch_tp import check_like_one_process, _spread

torch.set_num_threads(1)

WORLD, SPACE = 4, 2
JOIN_TIMEOUT = 120.0
TOL = dict(atol=1e-5, rtol=1e-4)
REL = 1e-5        # of the largest value (the layer and slice cases)
STEP1_RTOL = 1e-3
# (kind, in channels, out channels, kernel, stride, padding, input side)
CONVS = {"k3": ("conv", 4, 6, 3, 1, 1, 16),
         "k4s2": ("conv", 4, 6, 4, 2, 1, 16),
         "tconv": ("tconv", 4, 6, 4, 2, 1, 8),
         # the knob routes' case: their rule wants 8 channels or more
         "k3_knobs": ("conv", 8, 8, 3, 1, 1, 16)}
ATTN_CH, ATTN_SIDE = 16, 16
BN_C = 3
# the step cases (space, flags): the flagship's flags, the DCGAN family,
# the hybrid, the gradient penalty; the flagship at S = 4
FLAGSHIP = dict(BASE, biggan=True, hinge=True)
STEPS = {
    "flagship": (2, FLAGSHIP),
    "flagship_remat_stage": (2, dict(FLAGSHIP, remat=True,
                                     remat_scope="stage")),
    "flagship_remat_block": (2, dict(FLAGSHIP, remat=True,
                                     remat_scope="block")),
    "flagship_split": (2, dict(FLAGSHIP, fused_step=False)),
    "dcgan": (2, dict(BASE, dcgan=True)),
    "dcgan_msl": (2, dict(BASE, dcgan=True, msl=True)),
    "hybrid": (2, dict(BASE, hybrid=True, biggan=True)),
    "dcgan_gp": (2, dict(BASE, dcgan=True, gp_weight=10.0)),
    "flagship_s4": (4, FLAGSHIP),
}
CONV_CASES = [(name, s) for name in CONVS for s in (2, 4)
              if (name, s) != ("k3_knobs", 4)]
SLICE = dict(resolution=16, z_size=16, filterG=8, filterD=8, batch_size=4,
             iterD=1, biggan=True, hinge=True, compute_dtype="float32")
SLICE_REMAT = dict(remat=True, remat_scope="stage")
INPUTS = "inputs.pt"  # the layer cases' inputs, which the ranks read
CKPT = dict(BASE, biggan=True, hinge=True, niters=1, steps_per_log=1,
            steps_per_img_log=10, steps_per_ckpt=10, platform="cpu",
            data_loader_workers=1)


def rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def ndhwc(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def ncdhw(x):
    return np.moveaxis(np.asarray(x), -1, 1)


# ---------------------------------------------------------------------------
# the cases' inputs (no JAX compile: numpy and jax.eval_shape)
# ---------------------------------------------------------------------------
def conv_inputs(name):
    kind, ci, co, k, s, p, side = CONVS[name]
    rng = np.random.default_rng(len(name) + k)
    x = rand(rng, 2, ci, side, side, side)
    if kind == "conv":
        w = rand(rng, co, ci, k, k, k) * 0.2
        out = (side + 2 * p - k) // s + 1
    else:
        w = rand(rng, ci, co, k, k, k) * 0.2
        out = (side - 1) * s - 2 * p + k
    return {"x": x, "w": w, "b": rand(rng, co),
            "r": rand(rng, 2, co, out, out, out)}


def jax_tree(jmod, x, rng, spectral_unit=True):
    """A random variable tree of ``jmod``'s structure for input ``x``
    (NDHWC): N(0, 0.1) leaves, unit spectral-norm vectors."""
    import jax
    import jax.numpy as jnp

    def fill(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        v = rng.normal(size=leaf.shape)
        if names[0] == "spectral" and spectral_unit:
            return (v / np.linalg.norm(v)).astype(np.float32)
        return (v * 0.1).astype(np.float32)

    shapes = jax.eval_shape(jmod.init, jax.random.key(0), jnp.asarray(x))
    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(fill, shapes))


def attention_inputs():
    from gan3d_tpu.nn import SelfAttention3d as JSelfAttention3d

    rng = np.random.default_rng(21)
    n = ATTN_SIDE
    x = rand(rng, 2, ATTN_CH, n, n, n)
    jv = jax_tree(JSelfAttention3d(ATTN_CH), ndhwc(x), rng)
    jv["params"]["gamma"] = np.float32(0.7)
    sd = {}
    convert.attention_state(sd, "", jv["params"], jv["spectral"])
    return {"x": x, "r": rand(rng, 2, ATTN_CH, n, n, n), "jv": jv, "sd": sd}


def norm_inputs():
    rng = np.random.default_rng(22)
    bn = {"x": rand(rng, 8, BN_C, 8, 8, 8) * 2 + 0.5,
          "r": rand(rng, 8, BN_C, 8, 8, 8),
          "scale": rand(rng, BN_C), "bias": rand(rng, BN_C)}
    ln = {"x": rand(rng, 4, BN_C, 8, 8, 8) * 2 + 0.5,
          "r": rand(rng, 4, BN_C, 8, 8, 8),
          "scale": rand(rng, 8, 8, 8, BN_C), "bias": rand(rng, 8, 8, 8, BN_C)}
    return {"bn": bn, "ln": ln}


def slice_inputs():
    """Random JAX trees of SLICE's G and D, their port state dicts, the
    noise and the reals."""
    import jax
    import jax.numpy as jnp
    from gan3d_tpu.config import Config as JConfig
    from gan3d_tpu.models import build_models as jbuild

    from test_torch_biggan import random_variables

    jcfg = JConfig(**SLICE)
    G_j, D_j = jbuild(jcfg)
    r = SLICE["resolution"]
    g = jax.eval_shape(G_j.init, {"params": jax.random.key(0)},
                       jnp.zeros((2, SLICE["z_size"])))
    d = jax.eval_shape(D_j.init, {"params": jax.random.key(0)},
                       jnp.zeros((2, r, r, r, 1)))
    rng = np.random.default_rng(23)
    gv = jax.tree.map(np.asarray, random_variables(g, rng))
    dv = jax.tree.map(np.asarray, random_variables(d, rng))
    cfg = Config(**SLICE)
    b = SLICE["batch_size"]
    return {"gv": gv, "dv": dv,
            "g_sd": convert.from_jax_variables(gv, cfg, "g"),
            "d_sd": convert.from_jax_variables(dv, cfg, "d"),
            "z": rand(rng, b, SLICE["z_size"]),
            "real": np.tanh(rand(rng, b, 1, r, r, r))}


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------
def _slab(x, rp, side=None):
    """This rank's rows and depth slab of a whole global batch ``x``."""
    lo, hi = rp.span(x.shape[0])
    x = x[lo:hi]
    if sp.shards(x.shape[3], rp):
        a, b = sp.span(x.shape[2], rp)
        x = x[:, :, a:b]
    return x


def _grads(module):
    return {n: p.grad.clone() for n, p in module.named_parameters()
            if p.grad is not None}


def conv_case(rp, name, inp, knobs=False):
    kind = CONVS[name][0]
    _, ci, co, k, s, p, _ = CONVS[name]
    cls = Conv3d if kind == "conv" else ConvTranspose3d
    layer = cls(ci, co, k, s, p)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(inp["w"]))
        layer.bias.copy_(torch.from_numpy(inp["b"]))
    dist.attach(layer, rp)
    x = _slab(torch.from_numpy(inp["x"]), rp).requires_grad_(True)
    seen = []
    if knobs:
        conv_ops.set_wide_conv_mode("on")
        conv_ops.set_fast_dw_mode("on")
        from gan3d_tpu_torch.ops import cuda_conv

        apply = cuda_conv.WideConv3d.apply
        cuda_conv.WideConv3d.apply = lambda *a: (seen.append(
            tuple(a[0].shape)), apply(*a))[1]
    try:
        y = layer(x)
    finally:
        if knobs:
            cuda_conv.WideConv3d.apply = apply
            conv_ops.set_wide_conv_mode("auto")
            conv_ops.set_fast_dw_mode("auto")
    r = torch.from_numpy(inp["r"])
    r = _slab(r, rp) if sp.is_sharded(y) else r[slice(*rp.span(2))]
    (y * r).sum().backward()
    return {"y": y.detach(), "dx": x.grad, **_grads(layer),
            "knob_inputs": seen}


def attention_case(rp, inp):
    block = SelfAttention3d(ATTN_CH)
    block.load_state_dict(inp["sd"], strict=True)
    dist.attach(block, rp)
    x = _slab(torch.from_numpy(inp["x"]), rp).requires_grad_(True)
    y = block(x)
    (y * _slab(torch.from_numpy(inp["r"]), rp)).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "grads": _grads(block),
            "sn": {n: (getattr(block, n).parametrizations.weight[0]._u
                       .clone(),
                       getattr(block, n).parametrizations.weight[0]._v
                       .clone()) for n in ("f", "g", "h", "v")}}


def norm_case(rp, inp, which, sync=True):
    if which == "bn":
        mod = BatchNorm3d(BN_C)
        mod.sync = sync
        w, b = inp["scale"], inp["bias"]
    else:
        mod = LayerNormVolume((BN_C, 8, 8, 8))
        w, b = (np.moveaxis(inp[k], -1, 0) for k in ("scale", "bias"))
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
        mod.bias.copy_(torch.from_numpy(np.ascontiguousarray(b)))
    dist.attach(mod, rp)
    x = _slab(torch.from_numpy(inp["x"]), rp).requires_grad_(True)
    y = mod(x)
    (y * _slab(torch.from_numpy(inp["r"]), rp)).sum().backward()
    out = {"y": y.detach(), "dx": x.grad, "dw": mod.weight.grad,
           "db": mod.bias.grad}
    if which == "bn":
        out.update(mean=mod.running_mean.clone(), var=mod.running_var.clone())
    return out


@contextlib.contextmanager
def spied_groups():
    """Inside the block, the shape of every remat group's input
    (``remat``'s checkpoint calls, the recomputes' nested ones too) and
    the number of tensors ``sp.kept``'s hooks packed as a slab and its
    edge planes."""
    seen = {"group_inputs": [], "kept_packs": 0}
    ckpt, hooks = remat._checkpoint, torch.autograd.graph.saved_tensors_hooks

    def group(fn, x, **kw):
        seen["group_inputs"].append(tuple(x.shape))
        return ckpt(fn, x, **kw)

    class counted(hooks):
        def __init__(self, pack, unpack):
            def counting(t):
                p = pack(t)
                seen["kept_packs"] += (isinstance(p, tuple)
                                       and p[:1] == ("sp_halo",))
                return p
            super().__init__(counting, unpack)

    remat._checkpoint = group
    torch.autograd.graph.saved_tensors_hooks = counted
    try:
        yield seen
    finally:
        remat._checkpoint = ckpt
        torch.autograd.graph.saved_tensors_hooks = hooks


def slice_case(rp, inp, **flags):
    """SLICE's (with ``flags``) G forward, D's forwards of the reals and
    of G's output (the JAX side's fake, numpy) and D's hinge-loss
    gradient, made whole and averaged as the step does. With ``remat``
    G runs with gradients on (else its groups run as they are); what the
    groups keep is read by ``spied_groups``."""
    cfg = Config(**SLICE, **flags, spatial_devices=SPACE, num_devices=WORLD)
    G, D = build_models(cfg, rp)
    G.load_state_dict(inp["g_sd"])
    D.load_state_dict(inp["d_sd"])
    G.train()
    D.train()
    with spied_groups() as seen:
        with torch.set_grad_enabled(cfg.remat):
            fake = G(torch.from_numpy(inp["z"])[slice(*rp.span(4))])
        real = _slab(torch.from_numpy(inp["real"]), rp)
        fake_j = _slab(torch.from_numpy(inp["fake_j"]), rp)
        d_real, d_fake = D(real), D(fake_j)
        loss = torch.relu(1 - d_real).mean() + torch.relu(1 + d_fake).mean()
        params = list(D.parameters())
        grads = reduce_grads(rp, params, torch.autograd.grad(loss, params))
    return {"fake": fake.detach(), "d_real": d_real.detach(),
            "d_fake": d_fake.detach(),
            "loss": rp.mean([loss.detach().reshape(1)])[0],
            "grads": dict(zip([n for n, _ in D.named_parameters()],
                              grads)), **seen}


def run_steps(cfg, rp=None, steps=2, hooks=False):
    """``steps`` steps of ``cfg`` from its seeded weights on the global
    batch's reals (``reals_for``, a seed a step), this rank's rows and
    slab of them; with ``hooks``, the forms (slab or whole: 1 or 0) of
    every deep block's input and output in the first forward of G and
    D."""
    rp = rp or dist.ONE
    G, D = build_models(cfg, rp if rp is not dist.ONE else None)
    G.train()
    D.train()
    forms = {}
    handles = []
    if hooks:
        for tag, net in (("G", G), ("D", D)):
            for name, m in net.named_modules():
                if type(m).__name__ in ("GBlockDeep", "DBlockDeep"):
                    def hook(mod, args, out, key=f"{tag}.{name}"):
                        forms.setdefault(key, (
                            args[0].shape[3], sp.is_sharded(args[0]),
                            out.shape[3], sp.is_sharded(out)))
                    handles.append(m.register_forward_hook(hook))
    g_opt = RecAdam(G.parameters(), cfg.lrG, 0.0, 0.9)
    d_opt = RecAdam(D.parameters(), cfg.lrD, 0.0, 0.9)
    gen = torch.Generator().manual_seed(100)
    out = None
    for i in range(steps):
        reals = reals_for(cfg, seed=3 + i)
        lo, hi = rp.span(cfg.batch_size)
        reals = reals[:, lo:hi]
        if sp.on(rp):
            a, b = sp.span(cfg.resolution, rp)
            reals = reals[:, :, :, a:b]
        m, _ = train_step(cfg, G, D, g_opt, d_opt, reals, generator=gen,
                          replicas=rp)
        if i == 0:  # step 0's state, gradients and losses
            for h in handles:
                h.remove()
            out = copy.deepcopy(summary(dict(
                G=G, D=D, g_opt=g_opt, d_opt=d_opt, metrics=m,
                pl_mean=torch.zeros(()))))
            out["forms"] = forms
        else:
            out["step1"] = {k: float(v) for k, v in m.items()}
    return out


def _train(cfg, replicas=None):
    from gan3d_tpu_torch.data import open_dataset
    from gan3d_tpu_torch.train.trainer import Trainer

    Trainer(open_dataset(cfg.data_path), cfg, replicas).train()


def _wait_for(path):
    """``path`` once the test process has written it."""
    deadline = time.monotonic() + JOIN_TIMEOUT
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.05)
    return path


def rank_cases(rp, tmp, data):
    """Every case's spatial side (the steps and the checkpoint first, while
    the test process builds the other cases' inputs: ``INPUTS``); writes
    ``rank{r}.pt``."""
    torch.set_num_threads(1)
    rp4 = dist.grid(rp.rank, rp.world, rp.local_rank, rp.local_world,
                    rp.device, space=4)
    out = {"steps": {}}
    for name, (s, kw) in STEPS.items():
        out["steps"][name] = run_steps(
            Config(**kw, spatial_devices=s, num_devices=WORLD),
            rp if s == SPACE else rp4, hooks=name == "flagship_s4")
    # the checkpoint: one step at 2 x 2, resumed at S = 4 (and by the test
    # in one process)
    cfg = Config(**CKPT, data_path=data, num_devices=WORLD)
    _train(cfg.replace(log_dir=os.path.join(tmp, "sp_run"),
                       spatial_devices=SPACE), rp)
    if rp.main:
        for d in ("sp_for_s4", "sp_for_one"):
            shutil.copytree(os.path.join(tmp, "sp_run"),
                            os.path.join(tmp, d))
    rp.barrier()
    _train(cfg.replace(log_dir=os.path.join(tmp, "sp_for_s4"),
                       spatial_devices=4, niters=2), rp4)
    inp = torch.load(_wait_for(os.path.join(tmp, INPUTS)),
                     weights_only=False)
    out["conv"] = {}
    for s, r in ((2, rp), (4, rp4)):
        for name in CONVS:
            if (name, s) in CONV_CASES:
                out["conv"][(name, s)] = conv_case(
                    r, name, inp["conv"][name], knobs=name == "k3_knobs")
    out["attention"] = attention_case(rp, inp["attention"])
    out["bn"] = norm_case(rp, inp["norm"]["bn"], "bn")
    out["bn_sync_off"] = norm_case(rp, inp["norm"]["bn"], "bn", sync=False)
    out["ln"] = norm_case(rp, inp["norm"]["ln"], "ln")
    out["slice"] = slice_case(rp, torch.load(
        _wait_for(os.path.join(tmp, "slice.pt")), weights_only=False))
    out["slice_remat"] = slice_case(rp, torch.load(
        _wait_for(os.path.join(tmp, "slice_remat.pt")), weights_only=False),
        **SLICE_REMAT)
    torch.save(out, os.path.join(tmp, f"rank{rp.rank}.pt"))


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def jax_conv(inp, name):
    import jax
    import jax.numpy as jnp
    from gan3d_tpu.ops.conv3d import conv3d, conv_transpose3d

    kind, _, _, _, s, p, _ = CONVS[name]
    if kind == "conv":
        w = np.transpose(inp["w"], (2, 3, 4, 1, 0))

        def f(x, w):
            return conv3d(x, w, stride=s, padding=p) + inp["b"]
    else:
        w = np.transpose(inp["w"], (2, 3, 4, 0, 1))

        def f(x, w):
            return conv_transpose3d(x, w, stride=s, padding=p) + inp["b"]

    y, vjp = jax.vjp(jax.jit(f), jnp.asarray(ndhwc(inp["x"])),
                     jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(ndhwc(inp["r"])))
    dw = np.asarray(dw)
    dw = (np.transpose(dw, (4, 3, 0, 1, 2)) if kind == "conv"
          else np.transpose(dw, (3, 4, 0, 1, 2)))
    return {"y": ncdhw(y), "dx": ncdhw(dx), "weight": dw,
            "bias": inp["r"].sum(axis=(0, 2, 3, 4))}


def jax_attention(inp):
    import jax
    import jax.numpy as jnp
    from gan3d_tpu.nn import SelfAttention3d as JSelfAttention3d

    jmod = JSelfAttention3d(ATTN_CH)
    jv = inp["jv"]
    x = jnp.asarray(ndhwc(inp["x"]))
    r = jnp.asarray(ndhwc(inp["r"]))

    def loss(params, x):
        y, st = jmod.apply({"params": params, "spectral": jv["spectral"]},
                           x, mutable=["spectral"])
        return jnp.sum(y * r), (y, st)

    (_, (y, st)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jv["params"], x)
    sd = {}
    convert.attention_state(sd, "", jax.tree.map(np.asarray, gp),
                            jax.tree.map(np.asarray, st["spectral"]))
    return {"y": ncdhw(y), "dx": ncdhw(gx), "grads": sd}


def jax_norm(inp, which, groups=1):
    import jax
    import jax.numpy as jnp
    from gan3d_tpu.nn.norm import BatchNorm3d as JBN
    from gan3d_tpu.nn.norm import LayerNormVolume as JLN

    x = jnp.asarray(ndhwc(inp["x"]))
    r = jnp.asarray(ndhwc(inp["r"]))
    if which == "bn":
        jmod = JBN(BN_C, num_groups=groups)
        state = {"batch_stats": {"mean": np.zeros(BN_C, np.float32),
                                 "var": np.ones(BN_C, np.float32)}}
    else:
        jmod = JLN((8, 8, 8, BN_C))
        state = {}
    params = {"scale": inp["scale"], "bias": inp["bias"]}

    def loss(params, x):
        y, st = jmod.apply({"params": params, **state}, x,
                           mutable=list(state))
        return jnp.sum(y * r), (y, st)

    (_, (y, st)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    out = {"y": ncdhw(y), "dx": ncdhw(gx), "dw": np.asarray(gp["scale"]),
           "db": np.asarray(gp["bias"])}
    if which == "bn":
        out.update(mean=np.asarray(st["batch_stats"]["mean"]),
                   var=np.asarray(st["batch_stats"]["var"]))
    else:
        out.update(dw=np.moveaxis(out["dw"], -1, 0),
                   db=np.moveaxis(out["db"], -1, 0))
    return out


def jax_slice(inp, **flags):
    """SLICE (with ``flags``) on the JAX mesh make_mesh(4, spatial=2):
    G's train-mode forward, then D's forwards and hinge-loss gradient
    with G's output as the fake."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gan3d_tpu.config import Config as JConfig
    from gan3d_tpu.models import build_models as jbuild
    from gan3d_tpu.parallel.mesh import make_mesh

    jcfg = JConfig(**SLICE, **flags, num_devices=WORLD,
                   spatial_devices=SPACE)
    mesh = make_mesh(WORLD, spatial=SPACE)
    G_j, D_j = jbuild(jcfg)
    gv, dv = inp["gv"], inp["dv"]
    rep = NamedSharding(mesh, P())
    vol = NamedSharding(mesh, P("data", "space"))

    def g_fwd(v, z):
        return G_j.apply(v, z, train=True,
                         mutable=["batch_stats", "spectral"])[0]

    def d_loss(params, state, real, fake):
        out_r, st = D_j.apply({"params": params, **state}, real,
                              mutable=["spectral"])
        out_f, _ = D_j.apply({"params": params, **st}, fake,
                             mutable=["spectral"])
        loss = (jnp.mean(jax.nn.relu(1 - out_r))
                + jnp.mean(jax.nn.relu(1 + out_f)))
        return loss, (out_r, out_f)

    fake = jax.jit(g_fwd, in_shardings=(rep, rep), out_shardings=vol)(
        gv, jnp.asarray(inp["z"]))
    dstate = {k: v for k, v in dv.items() if k != "params"}
    grad = jax.jit(jax.value_and_grad(d_loss, has_aux=True),
                   in_shardings=(rep, rep, vol, vol),
                   out_shardings=((rep, (rep, rep)), rep))
    (loss, (out_r, out_f)), gp = grad(
        dv["params"], dstate, jnp.asarray(ndhwc(inp["real"])), fake)
    grads = convert.from_jax_variables(
        {"params": jax.tree.map(np.asarray, gp), **dstate},
        Config(**SLICE), "d")
    return {"fake": ncdhw(np.asarray(fake)), "d_real": np.asarray(out_r),
            "d_fake": np.asarray(out_f), "loss": float(loss),
            "grads": grads}


def jax_side(inp, tmp):
    """Every JAX reference; the slice's fake is written for the ranks."""
    from gan3d_tpu.ops.attention import set_attention_impl

    set_attention_impl("xla")
    try:
        out = {}
        for name, flags in (("slice", {}), ("slice_remat", SLICE_REMAT)):
            out[name] = jax_slice(inp["slice"], **flags)
            torch.save({**inp["slice"], "fake_j": out[name]["fake"]},
                       os.path.join(tmp, f"{name}.pt.tmp"))
            os.replace(os.path.join(tmp, f"{name}.pt.tmp"),
                       os.path.join(tmp, f"{name}.pt"))
        out["conv"] = {name: jax_conv(inp["conv"][name], name)
                       for name in CONVS}
        out["attention"] = jax_attention(inp["attention"])
    finally:
        set_attention_impl(None)
    out["bn"] = jax_norm(inp["norm"]["bn"], "bn")
    out["bn_sync_off"] = jax_norm(inp["norm"]["bn"], "bn", groups=WORLD)
    out["bn_model_sync_off"] = jax_norm(inp["norm"]["bn"], "bn", groups=2)
    out["ln"] = jax_norm(inp["norm"]["ln"], "ln")
    return out


# ---------------------------------------------------------------------------
# this process's side
# ---------------------------------------------------------------------------
def one_process_side(tmp, data):
    """The one-process steps of every case, the floor of each (BN's
    statistics in another order), and the one-process resume."""
    from chip_smoke import bn_formula

    refs, floors = {}, {}
    for name, (_, kw) in STEPS.items():
        cfg = Config(**kw)
        refs[name] = run_steps(cfg)
        with bn_formula():
            floors[name] = _spread(refs[name], run_steps(cfg, steps=1))
    return refs, floors


def model_axis_bn(inp):
    """The repair: BatchNorm without sync under a model axis of 2, whole
    channels, in one process (no collective runs)."""
    rp = dist.Replicas(rank=0, world=2, model=2)
    mod = BatchNorm3d(BN_C)
    mod.sync = False
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(inp["scale"]))
        mod.bias.copy_(torch.from_numpy(inp["bias"]))
    dist.attach(mod, rp)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y = mod(x)
    (y * torch.from_numpy(inp["r"])).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": mod.weight.grad,
            "db": mod.bias.grad, "mean": mod.running_mean,
            "var": mod.running_var}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Builds the inputs, starts the ranks, the JAX side and the
    one-process side; returns a function that waits for them: (every
    rank's results, the JAX results, the one-process refs and floors,
    the output directory, the data)."""
    tmp = tmp_path_factory.mktemp("sp")
    data = str(tmp / "train.npz")
    np.savez(data, X=np.tanh(np.random.default_rng(0).normal(
        size=(8, 16, 16, 16))).astype(np.float32))
    plan = dist.Plan(world=WORLD, local=WORLD, first=0, device="cpu",
                     space=SPACE)
    pool = ThreadPoolExecutor(max_workers=3)
    ranks_done = pool.submit(dist.launch, rank_cases, (str(tmp), data),
                             plan, JOIN_TIMEOUT)
    inp = {"conv": {name: conv_inputs(name) for name in CONVS},
           "attention": attention_inputs(), "norm": norm_inputs(),
           "slice": slice_inputs()}
    torch.save({k: v for k, v in inp.items() if k != "slice"},
               tmp / (INPUTS + ".tmp"))
    os.replace(tmp / (INPUTS + ".tmp"), tmp / INPUTS)
    jax_done = pool.submit(jax_side, inp, str(tmp))
    one_done = pool.submit(one_process_side, tmp, data)
    state = {}

    def wait():
        if "r" not in state:
            ranks_done.result()
            state["r"] = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                          for r in range(WORLD)]
            state["jax"] = jax_done.result()
            state["refs"] = one_done.result()
        return state["r"], state["jax"], state["refs"], tmp, data, inp

    try:
        yield wait
    finally:
        pool.shutdown(wait=True)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------
def close(got, want, rel=REL, msg=""):
    got = np.asarray(got)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    assert err <= rel, (msg, err, rel)


def assemble(parts, s):
    """The global batch from every rank's part (rank order, data-major):
    each data row's slabs concatenated on depth where they are slabs, the
    rows on the batch."""
    rows = [torch.cat(parts[d * s:(d + 1) * s], 2)
            if sp.is_sharded(parts[0]) else parts[d * s]
            for d in range(len(parts) // s)]
    return torch.cat(rows, 0).numpy()


@pytest.mark.parametrize("name,s", CONV_CASES)
def test_conv_on_slabs_matches_jax(ranks, name, s):
    """Forward, input and weight gradients of each conv on slabs; the
    knob case's conv went through K4's route on the halo'd slab."""
    rs, jx, _, _, _, _ = ranks()
    want = jx["conv"][name]
    got = [r["conv"][(name, s)] for r in rs]
    close(assemble([g["y"] for g in got], s), want["y"], msg="y")
    close(assemble([g["dx"] for g in got], s), want["dx"], msg="dx")
    for k in ("weight", "bias"):
        close(sum(g[k] for g in got).numpy(), want[k], msg=k)
    if name == "k3_knobs":  # the halo'd slab, padded 1, on the kernel route
        assert got[0]["knob_inputs"] == [(1, 8, 16 // s + 2, 16, 16)]
    else:
        assert got[0]["knob_inputs"] == []


def test_attention_on_query_slabs_matches_jax(ranks):
    """The block on slabs at data 2 x space 2: the output, the input and
    parameter gradients, and each projection's SN vectors after the
    forward (alike on every rank). (``want["grads"]`` is the JAX
    gradients and new spectral state in the port's keys.)"""
    rs, jx, _, _, _, _ = ranks()
    want = jx["attention"]
    got = [r["attention"] for r in rs]
    np.testing.assert_allclose(assemble([g["y"] for g in got], SPACE),
                               want["y"], **TOL)
    np.testing.assert_allclose(assemble([g["dx"] for g in got], SPACE),
                               want["dx"], atol=1e-4, rtol=1e-3)
    names = list(got[0]["grads"])
    assert len(names) == 5  # f, g, h, v and gamma
    for n in names:
        close(sum(g["grads"][n] for g in got).numpy(),
              want["grads"][n].numpy(), rel=1e-4, msg=n)
    for tag in ("f", "g", "h", "v"):
        for i, vec in enumerate(("_u", "_v")):
            key = f"{tag}.parametrizations.weight.0.{vec}"
            np.testing.assert_allclose(got[0]["sn"][tag][i].numpy(),
                                       want["grads"][key].numpy(), **TOL,
                                       err_msg=key)
            for g in got[1:]:
                assert torch.equal(g["sn"][tag][i], got[0]["sn"][tag][i])


@pytest.mark.parametrize("name", ["bn", "bn_sync_off", "bn_model_sync_off",
                                  "ln"])
def test_norms_on_slabs_match_jax(ranks, name):
    """BatchNorm with and without sync and LayerNormVolume on slabs at
    data 2 x space 2 (the gradients summed over the ranks, the running
    stats rank 0's); BatchNorm without sync under a model axis of 2."""
    rs, jx, _, _, _, inp = ranks()
    want = jx[name]
    if name == "bn_model_sync_off":
        g = model_axis_bn(inp["norm"]["bn"])
        y, dx, dw, db = (g[k].numpy() for k in ("y", "dx", "dw", "db"))
        mean, var = g["mean"], g["var"]
    else:
        got = [r[name] for r in rs]
        y = assemble([g["y"] for g in got], SPACE)
        dx = assemble([g["dx"] for g in got], SPACE)
        dw = sum(g["dw"] for g in got).numpy()
        db = sum(g["db"] for g in got).numpy()
        mean, var = got[0].get("mean"), got[0].get("var")
        for g in got[1:]:
            if mean is not None:
                assert torch.equal(g["mean"], mean)
                assert torch.equal(g["var"], var)
    np.testing.assert_allclose(y, want["y"], **TOL)
    np.testing.assert_allclose(dx, want["dx"], atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(dw, want["dw"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(db, want["db"], atol=1e-4, rtol=1e-4)
    if name != "ln":
        np.testing.assert_allclose(mean.numpy(), want["mean"], **TOL)
        np.testing.assert_allclose(var.numpy(), want["var"], **TOL)


def check_slice(want, got, part):
    """One part of a slice case: every rank's results against the JAX
    mesh program's."""
    if part == "g_forward":
        close(assemble([g["fake"] for g in got], SPACE), want["fake"],
              rel=1e-4, msg="G")
    elif part == "d_forward":
        for k in ("d_real", "d_fake"):
            close(assemble([g[k] for g in got], SPACE), want[k], msg=k)
        np.testing.assert_allclose(float(got[0]["loss"]), want["loss"],
                                   rtol=REL)
    else:
        top = max(v.abs().max().item() for v in want["grads"].values()
                  if v.is_floating_point())
        n = 0
        for name, g in got[0]["grads"].items():
            w = want["grads"][name]
            assert (g - w).abs().max().item() <= REL * top, (name,)
            for r in got[1:]:
                assert torch.equal(r["grads"][name], g), name
            n += 1
        assert n == len(got[0]["grads"]) > 10


@pytest.mark.parametrize("part", ["g_forward", "d_forward", "d_grads"])
def test_slice_matches_jax_spatial_mesh(ranks, part):
    """BigGAN at 16^3 on the port's data 2 x space 2 against the JAX
    program on make_mesh(4, spatial=2)."""
    rs, jx, _, _, _, _ = ranks()
    check_slice(jx["slice"], [r["slice"] for r in rs], part)
    if part == "d_grads":  # the spies' control: halo'd convs pack
        assert rs[0]["slice"]["kept_packs"] > 0
        assert rs[0]["slice"]["group_inputs"] == []


@pytest.mark.parametrize("part", ["g_forward", "d_forward", "d_grads"])
def test_slice_with_remat_matches_jax_spatial_mesh(ranks, part):
    """The same with remat per stage on both sides; every remat group's
    input on a rank is a slab (no halo), and ``sp.kept`` packed nothing:
    the checkpoint keeps each group's input alone."""
    rs, jx, _, _, _, _ = ranks()
    check_slice(jx["slice_remat"], [r["slice_remat"] for r in rs], part)
    for r in rs:
        inputs = r["slice_remat"]["group_inputs"]
        assert len(inputs) > 6, inputs  # G's and D's stages, recomputes
        for shape in inputs:
            assert shape[2] * SPACE == shape[3], shape
        assert r["slice_remat"]["kept_packs"] == 0


@pytest.mark.parametrize("name", list(STEPS))
def test_steps_match_one_process(ranks, name):
    """Step 0 of each case against one process (check_like_one_process,
    with the floor of BN's statistics in another order), step 1's losses,
    and the same state on every rank."""
    rs, _, (refs, floors), _, _, _ = ranks()
    got, want = rs[0]["steps"][name], refs[name]
    cfg = Config(**STEPS[name][1])
    check_like_one_process(got, want, floors[name])
    for k, v in want["step1"].items():  # after Adam's first updates
        np.testing.assert_allclose(got["step1"][k], v, rtol=STEP1_RTOL,
                                   atol=1e-6, err_msg=k)
    for r in rs[1:]:
        for w in ("g_sd", "d_sd"):
            for k, v in got[w].items():
                assert torch.equal(v, r["steps"][name][w][k]), (name, w, k)
    assert cfg.family() in ("biggan", "dcgan", "hybrid")


def test_thin_grid_runs_whole_at_s4(ranks):
    """At S = 4 the 4^3 grid (one plane a rank) runs whole on every rank:
    G's first block takes a whole 4^3 input and upsamples into an 8^3
    slab, D's last downsampling block pools an 8^3 slab into a whole 4^3;
    every side of 8^3 and up is a slab. (The same step held against one
    process: test_steps_match_one_process[flagship_s4].)"""
    rs, _, _, _, _, _ = ranks()
    forms = rs[0]["steps"]["flagship_s4"]["forms"]
    rp4 = dist.Replicas(world=4, space=4)
    assert not sp.shards(4, rp4) and sp.shards(8, rp4)
    assert forms, "no block ran"
    for key, (side_in, slab_in, side_out, slab_out) in forms.items():
        assert slab_in == (side_in >= 8), (key, forms[key])
        assert slab_out == (side_out >= 8), (key, forms[key])
    assert forms["G.blocks.0.0"] == (4, False, 4, False)  # --biggan's
    assert forms["G.blocks.1.0"] == (4, False, 8, True)  # the upsample
    last = [k for k in forms if k.startswith("D.")][-1]
    assert forms[last][2:] == (4, False)


def test_checkpoint_resumes_under_another_s(ranks, capsys):
    """A checkpoint written at data 2 x space 2 resumed at S = 4 (by the
    ranks) and in one process: the same next step."""
    rs, _, _, tmp, data, _ = ranks()
    cfg = Config(**CKPT, data_path=data)
    _train(cfg.replace(log_dir=str(tmp / "sp_for_one"), niters=2))
    assert "starting from step 1" in capsys.readouterr().out
    a = torch.load(tmp / "sp_for_s4" / "models" / "checkpoint.pt",
                   weights_only=True)
    b = torch.load(tmp / "sp_for_one" / "models" / "checkpoint.pt",
                   weights_only=True)
    assert a["step"] == b["step"] == 2
    np.testing.assert_allclose(a["lossD"], b["lossD"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(a["lossG"], b["lossG"], rtol=1e-4, atol=1e-6)
    # the 2 x 2 run's first step equals the one-process resume's history
    assert a["lossD"][0] == b["lossD"][0]


@pytest.mark.parametrize("groups", [1, 2])
def test_slab_batchnorm_at_one_rank(monkeypatch, groups):
    """The slab BatchNorm at one rank (the collective the identity) does
    what torch's BatchNorm does on each group of rows: the output, the
    input and affine gradients, the mean and the biased variance."""
    from gan3d_tpu_torch.nn import norm

    monkeypatch.setattr(norm.dist, "all_reduce", lambda t, group=None: t)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rand(rng, 6, 3, 4, 5, 5) * 2 + 0.5)
    r = torch.from_numpy(rand(rng, 6, 3, 4, 5, 5))
    w, b = (torch.from_numpy(rand(rng, 3)) for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y, mean, var, cnt = norm._SlabBatchNorm.apply(*leaves, groups, None, 1,
                                                  0, 1e-5)
    got = [y, *torch.autograd.grad((y * r).sum(), leaves), mean, var]
    assert cnt == 6 // groups * 4 * 5 * 5
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = torch.cat([torch.nn.functional.batch_norm(
        part, None, None, leaves[1], leaves[2], True, 0.1, 1e-5)
        for part in leaves[0].chunk(groups)])
    xs = x.reshape(groups, -1, 3, 100).transpose(1, 2).reshape(groups, 3, -1)
    want = [y, *torch.autograd.grad((y * r).sum(), leaves), xs.mean(-1),
            xs.var(-1, unbiased=False)]
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), e.detach().numpy(),
                                   **TOL)


@pytest.mark.parametrize("filters", [64, 8, 4])
def test_r256_slabs_and_attention_at_s4(filters):
    """256^3 at S = 4 without compute (the networks' layout read from
    Config's architecture tables, the attention blocks built at their
    channels): the rule slabs every grid from 8^3 up and leaves 4^3 whole;
    G's attention at 32^3 and D's at 16^3 take (L / 4, M, c) queries on
    a rank against the whole M pooled keys, which the K1/K2 wrapper
    admits (its last check, the device, is the one that fails here) at
    the flagship's filters 64 (c = 64 and 128) and the parity run's 8
    (c = 8 and 16); filters 4 gives G c = 4, which it refuses."""
    cfg = Config(resolution=256, filterG=filters, filterD=filters,
                 z_size=16, biggan=True, hinge=True)
    rp4 = dist.Replicas(world=4, space=4)
    g, d = cfg.biggan_g_arch(), cfg.biggan_d_arch()
    sides = {4, 256} | set(g["resolution"]) | set(d["resolution"])
    assert sorted(sides) == [4, 8, 16, 32, 64, 128, 256]
    assert [r for r in sorted(sides) if not sp.shards(r, rp4)] == [4]
    got = []
    for arch in (g, d):
        at = [i for i, r in enumerate(arch["resolution"])
              if arch["attention"][r]]
        assert len(at) == 1
        side = arch["resolution"][at[0]]
        c = SelfAttention3d(arch["out_channels"][at[0]]).c
        got.append((side ** 3 // 4, side ** 3 // 8, c))
    f = filters
    assert got == [(8192, 4096, f), (1024, 512, 2 * f)]
    for L, m, c in got:
        q = torch.empty((16, L, c), dtype=torch.bfloat16, device="meta")
        k = torch.empty((16, m, c), dtype=torch.bfloat16, device="meta")
        want = ("not a CUDA device" if c in cuda_attention.SUPPORTED_C
                else f"c={c} not in")
        with pytest.raises(ValueError, match=want):
            cuda_attention.check_inputs(q, k, k)
    assert (filters == 4) == (4 not in cuda_attention.SUPPORTED_C
                              and got[0][2] == 4)


@pytest.mark.parametrize("case", ["resolution", "spatial_and_model",
                                  "stylegan"])
def test_spatial_errors(tmp_path, case):
    from gan3d_tpu_torch.data import open_dataset
    from gan3d_tpu_torch.train.trainer import Trainer

    path = str(tmp_path / "d.npz")
    np.savez(path, X=np.zeros((4, 16, 16, 16), np.float32))
    cfg = Config(**BASE, platform="cpu", log_dir=str(tmp_path / "run"),
                 biggan=True, num_devices=4)
    if case == "resolution":
        with pytest.raises(ValueError, match="resolution 16 not divisible "
                                             "by spatial_devices 3"):
            Trainer(open_dataset(path), cfg.replace(spatial_devices=3,
                                                    num_devices=3))
        with pytest.raises(ValueError, match="not divisible"):
            dist.plan_for(cfg.replace(spatial_devices=3, num_devices=3))
    elif case == "spatial_and_model":
        with pytest.raises(ValueError, match="cannot be combined"):
            dist.grid(0, 4, 0, 4, torch.device("cpu"), model=2, space=2)
        with pytest.raises(ValueError, match="cannot be combined"):
            Trainer(open_dataset(path), cfg.replace(spatial_devices=2,
                                                    model_devices=2))
        with pytest.raises(ValueError, match="3 devices not divisible"):
            dist.plan(3, "cpu", spatial_devices=2)
    else:
        for fam in ("stylegan2", "stylegan"):
            with pytest.raises(ValueError, match="start the run with"):
                Trainer(open_dataset(path), cfg.replace(
                    biggan=False, spatial_devices=2, filterG=16,
                    filterD=16, **{fam: True}))

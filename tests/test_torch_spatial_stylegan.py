"""StyleGAN2 and StyleGAN-1 under spatial parallelism
(gan3d_tpu_torch/parallel/sp.py, models/stylegan/) on the CPU: gloo ranks
holding depth slabs against the JAX package (its resample ops, AdaIN,
trilinear upsample and minibatch-std, and its ("data", "space") mesh on
the virtual CPU devices of tests/conftest.py) and against the port's
one-process run.

One spawn for the module, as test_torch_spatial.py: the fixture ``ranks``
starts four gloo ranks (``parallel.launch``; joined within 120 s) that
run the port's side of every case, builds the inputs meanwhile (numpy,
and the JAX modules' variable trees through ``jax.eval_shape`` and a
numpy fill), and runs the JAX side in worker threads and the one-process
steps here. The ranks form data 2 x space 2 and, over the same processes,
one space group of 4. Cases and tolerances (f32):

- the layers on slabs at S = 2 and 4 against the JAX functions on the
  same inputs: ``upfirdn3d`` up (the generator's skip-image upsample)
  and down (the discriminator's skip FIR), ``conv3d_resample`` for D's
  conv1 (k3, down 2), D's skip (1x1, down 2) and G's up layer (k3, up
  2), the trilinear upsample (its two end slabs clamp), ``ada_in`` and
  minibatch-std: the gathered output, the gathered input gradient and
  the summed parameter gradients of sum(y * r), 1e-5 of the largest
  value;
- the slice against the JAX mesh: StyleGAN2's G forward (train mode,
  the JAX G's noise draws recorded and replayed), D's forward and the
  softplus loss's gradient at 16^3, filters 16, batch 4, on the port's
  data 2 x space 2 and on the JAX ``make_mesh(4, spatial=2)`` with the
  same weights: G's output to 1e-4 of its largest, D's logits and each
  gradient to 1e-5 of the largest;
- two training steps against the port's one process on the global batch
  (held to JAX by test_torch_stylegan{1,2}*.py), same seed and
  generator, for StyleGAN2 (step 0 is the lazy R1 + PL step), with
  ``sg2_reg_grads`` (the double backward through every halo), with
  ``remat``, StyleGAN-1, StyleGAN-1 with ``--wide_conv=on --fast_dw=on``
  (K4/K3's plain versions here, on every rank's halo'd slabs: the same
  count a step as one process) and StyleGAN2 at S = 4 (4^3 runs whole):
  step 0 by test_torch_tp.check_like_one_process, step 1's losses to
  1e-4, every rank's state and StyleGAN2's EMA bit-equal;
- a StyleGAN2 checkpoint written at data 2 x space 2 resumed at S = 4
  and in one process: the next step's losses agree to 1e-4;
- planted faults the checks catch: G's up layer with every halo of zeros
  (``sp.halo``), the trilinear upsample with its end planes zeroed;
- the order of collectives (the guard of PERF.md's C4): every collective
  of one StyleGAN2 step and one BigGAN step at data 2 x space 2 (also
  with remat per stage, whose recomputes exchange again, and with
  ``fused_step=False``), as (group members, op, shape), the same sequence
  on the ranks of a space group; and one BigGAN step at data 1 x space 2
  (two ranks and their own groups) runs every collective on one
  communicator.

Budget: under ~45 s on one worker (the spawn and the JAX compiles
overlap).
"""

import copy
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from gan3d_tpu_torch import convert
from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models import build_models
from gan3d_tpu_torch.models.stylegan import loss as sg_loss
from gan3d_tpu_torch.models.stylegan import resample as TR
from gan3d_tpu_torch.models.stylegan import stylegan1 as T1
from gan3d_tpu_torch.models.stylegan.discriminator import MinibatchStdLayer
from gan3d_tpu_torch.ops import conv3d as conv_ops
from gan3d_tpu_torch.parallel import dist, sp
from gan3d_tpu_torch.train.step import reduce_grads, train_step

from test_torch_dp import BASE, RecAdam, reals_for, summary
from test_torch_spatial import _slab, assemble, close, _wait_for
from test_torch_tp import check_like_one_process

torch.set_num_threads(1)

WORLD, SPACE = 4, 2
JOIN_TIMEOUT = 120.0
REL = 1e-5          # of the largest value (the layer and slice cases)
STEP1_RTOL = 1e-4
SG = dict(resolution=16, filterG=16, filterD=16, z_size=8, batch_size=4,
          iterD=1, compute_dtype="float32")
# (op, kernel, up, down, padding, flip_weight, gain, input side): the
# resample ops of the networks' layers
LAYERS = {
    "fir_up": ("fir", 0, 2, 1, [2, 1] * 3, True, 8.0, 8),
    "fir_down": ("fir", 0, 1, 2, 1, True, 1.0, 16),
    "conv1_down": ("conv", 3, 1, 2, 1, True, 1.0, 16),
    "skip_down": ("conv", 1, 1, 2, 0, True, 1.0, 16),
    "up": ("conv", 3, 2, 1, 1, False, 1.0, 8),
    "trilinear": ("tri", 0, 2, 1, 0, True, 1.0, 8),
    "ada_in": ("ada_in", 0, 1, 1, 0, True, 1.0, 8),
    "mbstd": ("mbstd", 0, 1, 1, 0, True, 1.0, 8),
}
LAYER_CASES = [(name, s) for name in LAYERS for s in (2, 4)]
CH = 3
# the step cases (space, flags, conv knobs)
STEPS = {
    "stylegan2": (2, dict(SG, stylegan2=True), False),
    "stylegan2_reg": (2, dict(SG, stylegan2=True, sg2_reg_grads=True),
                      False),
    "stylegan2_remat": (2, dict(SG, stylegan2=True, remat=True), False),
    "stylegan1": (2, dict(SG, stylegan=True), False),
    "stylegan1_knobs": (2, dict(SG, stylegan=True), True),
    "stylegan2_s4": (4, dict(SG, stylegan2=True), False),
}
CKPT = dict(SG, stylegan2=True, niters=1, steps_per_log=1,
            steps_per_img_log=10, steps_per_ckpt=10, platform="cpu",
            data_loader_workers=1)
INPUTS = "inputs.pt"
OPS = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
       "barrier")


def rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def ndhwc(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def ncdhw(x):
    return np.moveaxis(np.asarray(x), -1, 1)


# ---------------------------------------------------------------------------
# the cases' inputs
# ---------------------------------------------------------------------------
def layer_inputs(name):
    op, k, up, down, _, _, _, side = LAYERS[name]
    rng = np.random.default_rng(30 + len(name) + k)
    n = 8 if op == "mbstd" else 2
    x = rand(rng, n, CH, side, side, side)
    if op == "mbstd":
        x[1::2] *= 3.0  # the groups' statistics differ
    out = {"x": x}
    co = CH + 2
    if op == "conv":
        out["w"] = rand(rng, co, CH, k, k, k) * 0.3
    if op == "ada_in":
        out["style"] = rand(rng, n, 2 * CH)
    so = side * up // down
    c_out = {"conv": co, "mbstd": CH + 1}.get(op, CH)
    out["r"] = rand(rng, n, c_out, so, so, so)
    return out


def slice_inputs():
    """Random JAX trees of StyleGAN2's G and D at SG's widths, their port
    state dicts, z and the reals."""
    import jax
    import jax.numpy as jnp
    from gan3d_tpu.config import Config as JConfig
    from gan3d_tpu.models import build_models as jbuild

    from test_torch_stylegan2 import sg2_variables

    jcfg = JConfig(**SG, stylegan2=True)
    G_j, D_j = jbuild(jcfg)
    r, b = SG["resolution"], SG["batch_size"]
    keys = {"params": jax.random.key(0), "noise": jax.random.key(1)}
    g = jax.eval_shape(G_j.init, keys, jnp.zeros((b, SG["z_size"])))
    d = jax.eval_shape(D_j.init, keys, jnp.zeros((b, r, r, r, 1)))
    rng = np.random.default_rng(31)
    gv = jax.tree.map(np.asarray, sg2_variables(g, rng))
    dv = jax.tree.map(np.asarray, sg2_variables(d, rng))
    cfg = Config(**SG, stylegan2=True)
    return {"gv": gv, "dv": dv,
            "g_sd": convert.from_jax_variables(gv, cfg, "g"),
            "d_sd": convert.from_jax_variables(dv, cfg, "d"),
            "z": rand(rng, b, SG["z_size"]),
            "real": np.tanh(rand(rng, b, 1, r, r, r))}


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------
def port_layer(name, x, inp, rp, fault=False):
    """The port's op of LAYERS[name] on ``x`` (a slab under ``rp``);
    returns (y, the tensors whose gradients are summed over the ranks)."""
    op, k, up, down, pad, flip, gain, _ = LAYERS[name]
    if op == "fir":
        return TR.upfirdn3d(x, TR.setup_filter(), up=up, down=down,
                            padding=pad, gain=gain, rp=rp), {}
    if op == "conv":
        w = torch.from_numpy(inp["w"]).requires_grad_(True)
        return TR.conv3d_resample(x, w, TR.setup_filter(), up=up,
                                  down=down, padding=pad, flip_weight=flip,
                                  rp=rp), {"w": w}
    if op == "tri":
        if fault:  # the end planes zeroed, not repeated
            return conv_ops.upsample_trilinear3d(
                sp.halo(x, 1, 1, rp), 2)[:, :, 2:-2], {}
        return T1.upsample2x(x, rp), {}
    if op == "ada_in":
        style = torch.from_numpy(inp["style"])[slice(*rp.span(
            inp["style"].shape[0]))].requires_grad_(True)
        return T1.ada_in(x, style, rp=rp), {"style": style}
    layer = MinibatchStdLayer(4, 1)
    dist.attach(layer, rp)
    return layer(x), {}


def layer_case(rp, name, inp, fault=""):
    x = _slab(torch.from_numpy(inp["x"]), rp).requires_grad_(True)
    good = sp.halo
    if fault == "halo":
        from chip_smoke import _halo_of_zeros

        sp.halo = _halo_of_zeros
    try:
        y, leaves = port_layer(name, x, inp, rp, fault == "ends")
    finally:
        sp.halo = good
    (y * _slab(torch.from_numpy(inp["r"]), rp)).sum().backward()
    return {"y": y.detach(), "dx": x.grad,
            **{k: v.grad for k, v in leaves.items()}}


def slice_case(rp, inp):
    """StyleGAN2 G's train-mode forward with the JAX noise, D's forwards
    of the reals and of the JAX fake, and D's softplus-loss gradient made
    whole and averaged as the step does."""
    cfg = Config(**SG, stylegan2=True, spatial_devices=SPACE,
                 num_devices=WORLD)
    G, D = build_models(cfg, rp)
    G.load_state_dict(inp["g_sd"])
    D.load_state_dict(inp["d_sd"])
    G.train()
    D.train()
    rows = slice(*rp.span(SG["batch_size"]))
    with torch.no_grad():
        fake, _ = G(torch.from_numpy(inp["z"])[rows],
                    noise=[torch.from_numpy(d)[rows] for d in inp["noise"]])
    real = _slab(torch.from_numpy(inp["real"]), rp)
    fake_j = _slab(torch.from_numpy(inp["fake_j"]), rp)
    d_real, d_fake = D(real), D(fake_j)
    loss = (torch.nn.functional.softplus(d_fake).mean()
            + torch.nn.functional.softplus(-d_real).mean())
    params = list(D.parameters())
    grads = reduce_grads(rp, params, torch.autograd.grad(loss, params))
    return {"fake": fake, "d_real": d_real.detach(),
            "d_fake": d_fake.detach(),
            "grads": dict(zip([n for n, _ in D.named_parameters()],
                              grads))}


def run_steps(cfg, rp=None, steps=2, knobs=False):
    """``steps`` StyleGAN steps of ``cfg`` from its seeded weights on the
    global batch's reals (``reals_for``, a seed a step), this rank's rows
    and slab of them; with ``knobs`` the k3 convs take the K4/K3 routes,
    whose input shapes are recorded."""
    rp = rp or dist.ONE
    G, D = build_models(cfg, rp if rp is not dist.ONE else None)
    G.train()
    D.train()
    g_opt = RecAdam(G.parameters(), cfg.lrG, 0.0, 0.9)
    d_opt = RecAdam(D.parameters(), cfg.lrD, 0.0, 0.9)
    ema = ([p.detach().clone() for p in G.parameters()]
           if cfg.family() == "stylegan2" else [])
    pl_mean = torch.zeros(())
    gen = torch.Generator().manual_seed(100)
    seen = []
    if knobs:
        from gan3d_tpu_torch.ops import cuda_conv

        apply = cuda_conv.WideConv3d.apply
        cuda_conv.WideConv3d.apply = lambda *a: (seen.append(
            tuple(a[0].shape)), apply(*a))[1]
        conv_ops.set_wide_conv_mode("on")
        conv_ops.set_fast_dw_mode("on")
    out = None
    try:
        for i in range(steps):
            reals = reals_for(cfg, seed=3 + i)
            reals = reals[:, slice(*rp.span(cfg.batch_size))]
            if sp.on(rp):
                reals = reals[:, :, :, slice(*sp.span(cfg.resolution, rp))]
            m, _, pl_mean = sg_loss.train_step(
                cfg, G, D, g_opt, d_opt, reals, i, ema, pl_mean,
                generator=gen, replicas=rp)
            if i == 0:
                out = copy.deepcopy(summary(dict(
                    G=G, D=D, g_opt=g_opt, d_opt=d_opt, metrics=m,
                    pl_mean=pl_mean)))
                out["knob_inputs"] = list(seen)
            else:
                out["step1"] = {k: float(v) for k, v in m.items()}
    finally:
        if knobs:
            cuda_conv.WideConv3d.apply = apply
            conv_ops.set_wide_conv_mode("auto")
            conv_ops.set_fast_dw_mode("auto")
    out["ema"] = [e.clone() for e in ema]
    return out


def _train(cfg, replicas=None):
    from gan3d_tpu_torch.data import open_dataset
    from gan3d_tpu_torch.train.trainer import Trainer

    Trainer(open_dataset(cfg.data_path), cfg, replicas).train()


def recorded_collectives(fn, rp):
    """(``fn()``, every collective it issued as (group, op, shape), the
    number of distinct process groups they ran on). A group is named by
    its members relative to ``rp``'s: "world" (every rank), "space" (this
    rank's space group), "data" (its data group) or the members."""
    seq, groups, saved = [], set(), {}
    every = tuple(range(rp.world))
    space = tuple(range(rp.rank - rp.space_rank,
                        rp.rank - rp.space_rank + rp.space))
    data = tuple(range(rp.space_rank, rp.world, rp.space))

    def recorder(name):
        def record(*a, **kw):
            group = kw.get("group")
            group = tdist.group.WORLD if group is None else group
            groups.add(id(group))
            t = a[0] if a and torch.is_tensor(a[0]) else None
            if name in ("all_gather", "all_gather_into_tensor"):
                t = a[1]
            members = tuple(tdist.get_process_group_ranks(group))
            members = {every: "world", space: "space",
                       data: "data"}.get(members, members)
            seq.append((members, name, None if t is None else tuple(t.shape)))
            return saved[name](*a, **kw)
        return record

    for name in OPS:
        saved[name] = getattr(tdist, name)
        setattr(tdist, name, recorder(name))
    try:
        return fn(), seq, len(groups)
    finally:
        for name in OPS:
            setattr(tdist, name, saved[name])


def one_step(cfg, rp):
    """One step of ``cfg``'s family at ``rp`` from its seeded weights."""
    G, D = build_models(cfg, rp)
    G.train()
    D.train()
    g_opt = RecAdam(G.parameters(), cfg.lrG, 0.0, 0.9)
    d_opt = RecAdam(D.parameters(), cfg.lrD, 0.0, 0.9)
    reals = reals_for(cfg)[:, slice(*rp.span(cfg.batch_size))]
    reals = reals[:, :, :, slice(*sp.span(cfg.resolution, rp))]
    gen = torch.Generator().manual_seed(100)
    if cfg.family() == "stylegan2":
        ema = [p.detach().clone() for p in G.parameters()]
        return sg_loss.train_step(cfg, G, D, g_opt, d_opt, reals, 0, ema,
                                  torch.zeros(()), generator=gen,
                                  replicas=rp)[0]
    return train_step(cfg, G, D, g_opt, d_opt, reals, generator=gen,
                      replicas=rp)[0]


def order_case(rp):
    """The collectives of one StyleGAN2 and one BigGAN step (plain, with
    remat per stage, split) at data 2 x space 2, and of one BigGAN step
    at data 1 x space 2 over this rank's pair (its own world and space
    groups, made by every rank in one order, as ``dist.grid`` makes
    them)."""
    out = {}
    biggan = dict(BASE, biggan=True, hinge=True)
    for name, kw in (("stylegan2", dict(SG, stylegan2=True)),
                     ("biggan", biggan),
                     ("biggan_remat", dict(biggan, remat=True,
                                           remat_scope="stage")),
                     ("biggan_split", dict(biggan, fused_step=False))):
        cfg = Config(**kw, spatial_devices=SPACE, num_devices=WORLD)
        _, out[name], _ = recorded_collectives(lambda: one_step(cfg, rp),
                                               rp)
    pairs = {}
    for first in range(0, WORLD, SPACE):
        ranks = list(range(first, first + SPACE))
        pairs[first] = (tdist.new_group(ranks), tdist.new_group(ranks))
    world, space = pairs[rp.rank - rp.space_rank]
    rp1 = dist.Replicas(rank=rp.space_rank, world=SPACE, group=world,
                        space=SPACE, space_group=space)
    cfg = Config(**BASE, biggan=True, hinge=True, spatial_devices=SPACE,
                 num_devices=SPACE)
    _, out["biggan_data1"], out["biggan_data1_groups"] = (
        recorded_collectives(lambda: one_step(cfg, rp1), rp))
    return out


def rank_cases(rp, tmp, data):
    """Every case's spatial side; writes ``rank{r}.pt``."""
    torch.set_num_threads(1)
    rp4 = dist.grid(rp.rank, rp.world, rp.local_rank, rp.local_world,
                    rp.device, space=4)
    out = {"steps": {}}
    for name, (s, kw, knobs) in STEPS.items():
        out["steps"][name] = run_steps(
            Config(**kw, spatial_devices=s, num_devices=WORLD),
            rp if s == SPACE else rp4, knobs=knobs)
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
    out["order"] = order_case(rp)
    inp = torch.load(_wait_for(os.path.join(tmp, INPUTS)),
                     weights_only=False)
    out["layers"] = {}
    for s, r in ((2, rp), (4, rp4)):
        for name in LAYERS:
            out["layers"][(name, s)] = layer_case(r, name,
                                                  inp["layers"][name])
    out["fault"] = {"up": layer_case(rp, "up", inp["layers"]["up"],
                                     "halo"),
                    "trilinear": layer_case(rp, "trilinear",
                                            inp["layers"]["trilinear"],
                                            "ends")}
    out["slice"] = slice_case(rp, torch.load(
        _wait_for(os.path.join(tmp, "slice.pt")), weights_only=False))
    torch.save(out, os.path.join(tmp, f"rank{rp.rank}.pt"))


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def jax_layer(name, inp):
    """The JAX function of LAYERS[name] and its vjp of sum(y * r): the
    output, the input gradient and the other inputs' gradients."""
    import jax
    import jax.numpy as jnp
    from gan3d_tpu.models.stylegan import resample as JR
    from gan3d_tpu.models.stylegan import stylegan1 as J1
    from gan3d_tpu.models.stylegan.discriminator import \
        MinibatchStdLayer as JMinibatchStd
    from gan3d_tpu.ops.conv3d import upsample_trilinear3d

    op, k, up, down, pad, flip, gain, _ = LAYERS[name]
    args = [jnp.asarray(ndhwc(inp["x"]))]
    if op == "fir":
        def f(x):
            return JR.upfirdn3d(x, JR.setup_filter(), up=up, down=down,
                                padding=pad, gain=gain)
    elif op == "conv":
        args.append(jnp.asarray(np.transpose(inp["w"], (2, 3, 4, 1, 0))))

        def f(x, w):
            return JR.conv3d_resample(x, w, f=JR.setup_filter(), up=up,
                                      down=down, padding=pad,
                                      flip_weight=flip)
    elif op == "tri":
        def f(x):
            return upsample_trilinear3d(x, 2)
    elif op == "ada_in":
        args.append(jnp.asarray(inp["style"]))
        f = J1.ada_in
    else:
        def f(x):
            return JMinibatchStd(4, 1).apply({}, x)
    y, vjp = jax.vjp(jax.jit(f), *args)
    grads = vjp(jnp.asarray(ndhwc(inp["r"])))
    out = {"y": ncdhw(y), "dx": ncdhw(grads[0])}
    if op == "conv":
        out["w"] = np.transpose(np.asarray(grads[1]), (4, 3, 0, 1, 2))
    if op == "ada_in":
        out["style"] = np.asarray(grads[1])
    return out


def jax_slice(inp):
    """StyleGAN2 on the JAX mesh make_mesh(4, spatial=2): G's train-mode
    forward (its noise draws returned), then D's forwards and
    softplus-loss gradient with G's output as the fake."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gan3d_tpu.config import Config as JConfig
    from gan3d_tpu.models import build_models as jbuild
    from gan3d_tpu.parallel.mesh import make_mesh

    from test_torch_stylegan2 import captured_draws

    jcfg = JConfig(**SG, stylegan2=True, num_devices=WORLD,
                   spatial_devices=SPACE)
    mesh = make_mesh(WORLD, spatial=SPACE)
    G_j, D_j = jbuild(jcfg)
    rep = NamedSharding(mesh, P())
    vol = NamedSharding(mesh, P("data", "space"))

    def g_fwd(v, z):
        with captured_draws() as draws:
            img, _ = G_j.apply(v, z, train=True,
                               rngs={"noise": jax.random.key(3)})
        return img, draws

    def d_loss(params, real, fake):
        out_r = D_j.apply({"params": params}, real)
        out_f = D_j.apply({"params": params}, fake)
        loss = (jnp.mean(jax.nn.softplus(out_f))
                + jnp.mean(jax.nn.softplus(-out_r)))
        return loss, (out_r, out_f)

    fake, draws = jax.jit(g_fwd, in_shardings=(rep, rep),
                          out_shardings=(vol, rep))(
        inp["gv"], jnp.asarray(inp["z"]))
    grad = jax.jit(jax.value_and_grad(d_loss, has_aux=True),
                   in_shardings=(rep, vol, vol),
                   out_shardings=((rep, (rep, rep)), rep))
    (_, (out_r, out_f)), gp = grad(
        inp["dv"]["params"], jnp.asarray(ndhwc(inp["real"])), fake)
    grads = convert.from_jax_variables(
        {"params": jax.tree.map(np.asarray, gp)},
        Config(**SG, stylegan2=True), "d")
    return {"fake": ncdhw(np.asarray(fake)), "d_real": np.asarray(out_r),
            "d_fake": np.asarray(out_f), "grads": grads,
            "noise": [np.ascontiguousarray(ncdhw(np.asarray(d)))
                      for d in draws]}


def jax_side(inp, tmp):
    """Every JAX reference; the slice's fake and noise are written for the
    ranks."""
    out = {"slice": jax_slice(inp["slice"])}
    torch.save({**inp["slice"], "fake_j": out["slice"]["fake"],
                "noise": out["slice"]["noise"]},
               os.path.join(tmp, "slice.pt.tmp"))
    os.replace(os.path.join(tmp, "slice.pt.tmp"),
               os.path.join(tmp, "slice.pt"))
    out["layers"] = {name: jax_layer(name, inp["layers"][name])
                     for name in LAYERS}
    return out


# ---------------------------------------------------------------------------
# this process's side
# ---------------------------------------------------------------------------
def one_process_side():
    """The one-process steps of every case."""
    return {name: run_steps(Config(**kw), knobs=knobs)
            for name, (_, kw, knobs) in STEPS.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the ranks, builds the inputs, runs the JAX side and the
    one-process side; returns a function that waits for them: (every
    rank's results, the JAX results, the one-process runs, the output
    directory, the data)."""
    tmp = tmp_path_factory.mktemp("sp_sg")
    data = str(tmp / "train.npz")
    np.savez(data, X=np.tanh(np.random.default_rng(0).normal(
        size=(8, 16, 16, 16))).astype(np.float32))
    plan = dist.Plan(world=WORLD, local=WORLD, first=0, device="cpu",
                     space=SPACE)
    pool = ThreadPoolExecutor(max_workers=3)
    ranks_done = pool.submit(dist.launch, rank_cases, (str(tmp), data),
                             plan, JOIN_TIMEOUT)
    inp = {"layers": {name: layer_inputs(name) for name in LAYERS},
           "slice": slice_inputs()}
    torch.save({"layers": inp["layers"]}, tmp / (INPUTS + ".tmp"))
    os.replace(tmp / (INPUTS + ".tmp"), tmp / INPUTS)
    jax_done = pool.submit(jax_side, inp, str(tmp))
    one_done = pool.submit(one_process_side)
    state = {}

    def wait():
        if "r" not in state:
            ranks_done.result()
            state["r"] = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                          for r in range(WORLD)]
            state["jax"] = jax_done.result()
            state["refs"] = one_done.result()
        return state["r"], state["jax"], state["refs"], tmp, data

    try:
        yield wait
    finally:
        pool.shutdown(wait=True)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------
def _layer_errors(got, want, s):
    """The largest relative error of the output, the input gradient and
    the other gradients: the weight's summed over the ranks, the style
    rows' over each space group."""
    errs = {}
    for k in want:
        parts = [r[k] for r in got]
        if k in ("y", "dx"):
            g = assemble(parts, s)
        elif k == "style":
            g = torch.cat([sum(parts[d:d + s])
                           for d in range(0, len(parts), s)]).numpy()
        else:
            g = sum(parts).numpy()
        assert g.shape == want[k].shape, (k, g.shape, want[k].shape)
        errs[k] = np.abs(g - want[k]).max() / max(np.abs(want[k]).max(),
                                                  1e-30)
    return errs


@pytest.mark.parametrize("name,s", LAYER_CASES)
def test_layers_on_slabs_match_jax(ranks, name, s):
    """Each StyleGAN op on slabs of S = 2 and 4 against the JAX function:
    the output, the input gradient and the summed parameter
    gradients."""
    rs, jx, _, _, _ = ranks()
    got = [r["layers"][(name, s)] for r in rs]
    errs = _layer_errors(got, jx["layers"][name], s)
    assert max(errs.values()) <= REL, errs
    assert set(errs) >= {"y", "dx"}


@pytest.mark.parametrize("name", ["up", "trilinear"])
def test_planted_faults_are_caught(ranks, name):
    """G's up layer with every halo of zeros, and the trilinear upsample
    with its end planes zeroed (``sp.halo`` without ``edge``), fail the
    layer check."""
    rs, jx, _, _, _ = ranks()
    errs = _layer_errors([r["fault"][name] for r in rs], jx["layers"][name],
                         SPACE)
    assert errs["y"] > 100 * REL, errs


@pytest.mark.parametrize("part", ["g_forward", "d_forward", "d_grads"])
def test_slice_matches_jax_spatial_mesh(ranks, part):
    """StyleGAN2 at 16^3 on the port's data 2 x space 2 against the JAX
    program on make_mesh(4, spatial=2)."""
    rs, jx, _, _, _ = ranks()
    want = jx["slice"]
    got = [r["slice"] for r in rs]
    if part == "g_forward":
        close(assemble([g["fake"] for g in got], SPACE), want["fake"],
              rel=1e-4, msg="G")
    elif part == "d_forward":
        for k in ("d_real", "d_fake"):
            close(assemble([g[k] for g in got], SPACE), want[k], msg=k)
    else:
        top = max(v.abs().max().item() for v in want["grads"].values())
        for name, g in got[0]["grads"].items():
            w = want["grads"][name]
            assert (g - w).abs().max().item() <= REL * top, (name,)
            for r in got[1:]:
                assert torch.equal(r["grads"][name], g), name
        assert len(got[0]["grads"]) == len(want["grads"]) > 10


@pytest.mark.parametrize("name", list(STEPS))
def test_steps_match_one_process(ranks, name):
    """Step 0 of each case against one process, step 1's losses, and the
    same state (and StyleGAN2's EMA) on every rank; the knob run took
    K4's route on the halo'd slabs as often as one process."""
    rs, _, refs, _, _ = ranks()
    got, want = rs[0]["steps"][name], refs[name]
    check_like_one_process(got, want, stateful=False)
    for k, v in want["step1"].items():
        np.testing.assert_allclose(got["step1"][k], v, rtol=STEP1_RTOL,
                                   atol=1e-7, err_msg=k)
    for r in rs[1:]:
        mine = r["steps"][name]
        for w in ("g_sd", "d_sd"):
            for k, v in got[w].items():
                assert torch.equal(v, mine[w][k]), (name, w, k)
        assert len(mine["ema"]) == len(got["ema"])
        assert all(torch.equal(a, b) for a, b in zip(got["ema"],
                                                     mine["ema"]))
    s, kw, knobs = STEPS[name]
    if Config(**kw).family() == "stylegan2":
        assert got["ema"] and got["pl_mean"] > 0
    if knobs:
        # 4 eligible convs (C1-C4), iterD + 1 G forwards a step
        assert len(got["knob_inputs"]) == len(want["knob_inputs"]) == 4 * 2
        r = SG["resolution"]
        assert {k[2] for k in got["knob_inputs"]} == {
            side // s + 2 for side in (4, 8, 16) if side // s >= 2}
        assert {k[2] for k in want["knob_inputs"]} == {4, 8, 16}
        assert all(k[3] in (4, 8, r) for k in got["knob_inputs"])


def test_checkpoint_resumes_under_another_s(ranks, capsys):
    """A StyleGAN2 checkpoint written at data 2 x space 2 resumed at S = 4
    (by the ranks) and in one process: the same next step."""
    rs, _, _, tmp, data = ranks()
    cfg = Config(**CKPT, data_path=data)
    _train(cfg.replace(log_dir=str(tmp / "sp_for_one"), niters=2))
    assert "starting from step 1" in capsys.readouterr().out
    a = torch.load(tmp / "sp_for_s4" / "models" / "checkpoint.pt",
                   weights_only=True)
    b = torch.load(tmp / "sp_for_one" / "models" / "checkpoint.pt",
                   weights_only=True)
    assert a["step"] == b["step"] == 2
    np.testing.assert_allclose(a["lossD"], b["lossD"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(a["lossG"], b["lossG"], rtol=1e-4, atol=1e-7)
    assert a["lossD"][0] == b["lossD"][0]
    assert float(a["pl_mean"]) == float(b["pl_mean"]) > 0


@pytest.mark.parametrize("name", ["stylegan2", "biggan", "biggan_data1",
                                  "biggan_remat", "biggan_split"])
def test_collectives_in_one_order(ranks, name):
    """The ranks of each space group issue the same collectives in the
    same order (group, op, shape); at data 1 every collective of the
    step, BatchNorm's statistics with the halos, runs on one
    communicator. With remat the recomputes add the groups' halos and
    statistics again."""
    rs, _, _, _, _ = ranks()
    seqs = [r["order"][name] for r in rs]
    for first in range(0, WORLD, SPACE):
        group = seqs[first:first + SPACE]
        assert group[0], name
        for other in group[1:]:
            assert other == group[0], name
    ops = {op for _, op, _ in seqs[0]}
    assert "all_gather_into_tensor" in ops or "all_gather" in ops  # halos
    if name == "biggan_data1":
        assert all(r["order"]["biggan_data1_groups"] == 1 for r in rs)
        assert {m for m, _, _ in seqs[0]} == {"space"}
    else:
        assert {m for m, _, _ in seqs[0]} >= {"space", "data"}
    if name == "biggan_remat":
        assert len(seqs[0]) > len(rs[0]["order"]["biggan"])

"""Tensor parallelism (gan3d_tpu_torch/parallel/tp.py) on the CPU: four
gloo ranks as data 2 x model 2 against the port's one-process run on the
global batch, and against the JAX package's TP program on the virtual CPU
mesh (tests/conftest.py).

One spawn for the module: the fixture ``ranks`` starts the four ranks
(``parallel.launch``, the train CLI's launcher; joined within 120 s) that
run the TP side of every case and write what each case reads; meanwhile
this process runs the one-process side and, in a worker thread, the JAX
step. Each case is then asserted in its own test. Cases and tolerances:

- the sharded set: the parameter names the port's rule shards over a
  model axis of 2 (``tp.plan``) against the leaves JAX's ``tp_shardings``
  shards, read through ``convert.from_jax_variables`` of a marker fill
  (1 where JAX shards a leaf, 0 elsewhere) of the JAX init's shapes
  (``jax.eval_shape``), and the number of sharded leaves of the train
  state (``count_sharded`` of the JAX TrainState; in the port the shards
  of the parameters, of Adam's moments and of StyleGAN2's EMA), for the
  flagship's flags, ``--dcgan --sagan`` (the DCGAN attention's
  projections, auto-named ``SelfAttention3d_0`` in JAX, are sharded) and
  StyleGAN2 (its const and mapping);
- one step at data 2 x model 2 against the port's one-process step on the
  global batch, same seed and generator, to test_torch_dp.py's
  tolerances (losses rtol 1e-5; each gathered gradient before Adam within
  1e-5 of the update's largest and 1e-4 of its own largest; parameters,
  BN running stats and SN vectors by its scheme), for the flagship's
  flags, ``--dcgan``, ``--dcgan --sagan --hinge``, the hybrid, StyleGAN2
  on its lazy step 0 (R1 and the path length, ``sg2_reg_grads``),
  StyleGAN-1 and the flagship with ``--remat=True``. Widths where the
  rule shards layers of every kind: filters 16 at 16^3, the DCGAN with
  attention at 32^3 (D filters 64), StyleGAN at 8^3 with filters 128. One
  reading more than test_torch_dp.py: a gradient's error may reach 3x the
  step's own spread (the floor the card's dp phase uses): the larger of
  the gradient's move at data 2 without a model axis (the data group
  alone, run by the same ranks) and, for the flagship's D, the
  one-process gradient's move at 4 threads against 1. At filters 16 the
  BigGAN G's BN scales and biases move by up to 2.2e-2 of themselves
  (5e-5 of the update's largest) at data 2, with or without a model axis
  (the cross-replica BatchNorm's explicit two-pass formula against
  torch's kernel: chip_smoke.bn_formula); StyleGAN D's output bias, a
  sum of +-0.5 terms, by 1e-3 of its own 6e-5; the flagship D's first
  deep block's conv1 weight gradient by 3.8e-4 of itself between 1 and 4
  threads and at 2 model ranks alike (its input gradient summed in two
  halves);
- each sharded spectral norm applied once at the seed's weights: sigma,
  ``_u`` and ``_v`` against one process's, 1e-5;
- the slice against the JAX Trainer's TP programs (the BigGAN case of
  tests/test_tp.py:75-99: 16^3, filters 8, batch 4, ``num_devices=4,
  model_devices=2``): its mesh, ``tp_shardings`` of the state and its
  split mode's D and G programs (``fused_step=False``, numerically the
  fused step; compiled side by side) jitted with its shardings and the
  attention lowered through XLA (gan3d_tpu/train/trainer.py:131-148,
  216-223, 309-324; the Trainer's init, 40 s of compiles here, is left
  out), from random weights carried
  over with ``convert.from_jax_variables`` and the JAX step's noise
  injected: the losses at test_tp.py's 5e-3, the gradient magnitudes and
  parameters by test_torch_dp.py's JAX scheme;
- checkpoints: a one-process checkpoint resumed at data 2 x model 2, and
  a TP run's checkpoint resumed in one process, each against the other
  kind of run resuming the same file (no step left: the sample grid's G
  forward and the final save): the parameters and Adam's moments
  bit-equal, the BN and SN state to test_torch_dp.py's STATE_TOL;
- the replica check failing on every rank once one rank holds a changed
  shard;
- the grid's errors: spatial with model parallelism, a world the model
  axis does not divide, a batch the data ranks do not divide.

Budget: under 40 s on one worker (the spawn and the JAX compile overlap).
"""

import functools
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models import build_models
from gan3d_tpu_torch.models.stylegan import loss as sg_loss
from gan3d_tpu_torch.parallel import dist, tp
from gan3d_tpu_torch.train.step import train_step

from test_torch_dp import (GRAD_TOL, LOSS_RTOL, OWN_TOL, STATE_TOL, ZERO,
                           RecAdam, reals_for, summary)

torch.set_num_threads(1)

WORLD, MODEL = 4, 2
# a hung rank's limit: the four ranks take ~15 s alone and ~50 s beside
# the suite's other workers (test_torch_dp.py's two take its 50)
JOIN_TIMEOUT = 120.0
FLOOR_X = 3.0     # of the step's own spread (module docstring)
FLOOR_THREADS = 4
FLOOR_CASES = ("flagship", "remat")  # where the thread count moves a gradient

BASE = dict(resolution=16, filterG=16, filterD=16, z_size=8, batch_size=4,
            iterD=2, compute_dtype="float32")
SG = dict(resolution=8, filterG=128, filterD=128, z_size=8, iterD=2,
          compute_dtype="float32")
CASES = {
    "flagship": dict(BASE, biggan=True, hinge=True),
    "dcgan": dict(BASE, dcgan=True),
    "dcgan_sagan": dict(BASE, dcgan=True, sagan=True, hinge=True,
                        resolution=32, filterD=64),
    "hybrid": dict(BASE, hybrid=True, biggan=True),
    "stylegan2": dict(SG, stylegan2=True, batch_size=8, sg2_reg_grads=True),
    "stylegan1": dict(SG, stylegan=True, batch_size=4),
    "remat": dict(BASE, biggan=True, hinge=True, remat=True),
}
# the JAX comparison: tests/test_tp.py's BigGAN case
JAX_CASE = dict(resolution=16, z_size=16, filterG=8, filterD=8,
                batch_size=4, iterD=2, biggan=True, hinge=True,
                compute_dtype="float32")
# the sharded-set cases (the flagship's flags at JAX_CASE's widths, whose
# JAX trees the JAX comparison reuses) and the spectral-norm cases
RULE_CASES = {"flagship": JAX_CASE, "dcgan_sagan": CASES["dcgan_sagan"],
              "stylegan2": CASES["stylegan2"]}
SN_CASES = ("flagship", "dcgan_sagan")
JAX_IN = "jax_in.pt"  # the JAX comparison's inputs, which the ranks read
ONE_READY = "one_ready"  # the one-process checkpoint's copies are there
# the checkpoint cases' run
CKPT = dict(BASE, biggan=True, hinge=True, niters=1, steps_per_log=1,
            steps_per_img_log=10, steps_per_ckpt=10, platform="cpu",
            data_loader_workers=1)


def _fake_grid(rank=0):
    """A rank's place in the grid, without a process group (the rule and
    the slices need no collective)."""
    return dist.Replicas(rank=rank, world=WORLD, model=MODEL)


def run_step(cfg, replicas=None, weights=None, noises=None):
    """test_torch_dp.run_step under a model axis: step 0 of ``cfg``'s
    family from its seeded weights (or ``weights``, whole state_dicts,
    which a sharded net slices), the rank's rows of ``reals_for``."""
    rp = replicas or dist.ONE
    G, D = build_models(cfg, replicas)
    if weights is not None:
        for net, sd in zip((G, D), weights):
            if tp.on(rp):
                tp.load_full_state_dict(net, sd, rp)
            else:
                net.load_state_dict(sd)
    G.train()
    D.train()
    g_opt = RecAdam(G.parameters(), cfg.lrG, 0.0, 0.9)
    d_opt = RecAdam(D.parameters(), cfg.lrD, 0.0, 0.9)
    lo, hi = rp.span(cfg.batch_size)
    reals = reals_for(cfg)[:, lo:hi]
    fam = cfg.family()
    ema = [p.detach().clone() for p in G.parameters()] \
        if fam == "stylegan2" else []
    pl_mean = torch.zeros(())
    gen = torch.Generator().manual_seed(100)
    if fam in ("stylegan", "stylegan2"):
        metrics, _, pl_mean = sg_loss.train_step(
            cfg, G, D, g_opt, d_opt, reals, 0, ema, pl_mean, generator=gen,
            replicas=rp)
    else:
        metrics, _ = train_step(cfg, G, D, g_opt, d_opt, reals,
                                generator=gen, noises=noises, replicas=rp)
    return dict(G=G, D=D, g_opt=g_opt, d_opt=d_opt, metrics=metrics,
                pl_mean=pl_mean)


def full_summary(run, rp):
    """``summary`` with every shard gathered whole (every rank takes part),
    and the nets' plans."""
    out = summary(run)
    for w, net, opt in (("g", run["G"], run["g_opt"]),
                        ("d", run["D"], run["d_opt"])):
        out[f"{w}_sd"] = tp.full_state_dict(net, rp)
        out[f"{w}_grads"] = [tp.full_moments(opt.params, gs, rp)
                             for gs in opt.seen]
        out[f"{w}_nu"] = tp.full_moments(opt.params, opt.nu, rp)
        out[f"{w}_plan"] = dict(net.tp_plan)
    return out


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------
def _train(cfg, replicas=None):
    from gan3d_tpu_torch.data import open_dataset
    from gan3d_tpu_torch.train.trainer import Trainer

    Trainer(open_dataset(cfg.data_path), cfg, replicas).train()


def _ckpt(log_dir):
    return torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                      weights_only=True)


def ckpt_case(rp, tmp, data):
    """Resume the one-process checkpoint ``one_for_tp`` (no step left), and
    train one step from scratch into ``tp_run``, then resume a copy of it
    (``tp_for_tp``); this process's side of the checkpoint cases."""
    cfg = Config(**CKPT, data_path=data, num_devices=WORLD,
                 model_devices=MODEL)
    _wait_for(os.path.join(tmp, ONE_READY))  # the test process's run
    _train(cfg.replace(log_dir=os.path.join(tmp, "one_for_tp")), rp)
    _train(cfg.replace(log_dir=os.path.join(tmp, "tp_run")), rp)
    if rp.main:
        shutil.copytree(os.path.join(tmp, "tp_run"),
                        os.path.join(tmp, "tp_for_tp"))
    rp.barrier()
    _train(cfg.replace(log_dir=os.path.join(tmp, "tp_for_tp")), rp)


def replica_case(rp):
    """The replica check on a replicated tensor and a shard (alike within
    each data group), then with rank 3's shard changed."""
    rep = [torch.arange(6.0)]
    shards = [torch.full((4,), float(rp.model_rank))]
    n = rp.check(rep, shards)
    if rp.rank == 3:
        shards[0][1] += 1e-3
    try:
        rp.check(rep, shards)
        caught = ""
    except RuntimeError as e:
        caught = str(e)
    return {"n": n, "caught": caught}


def sn_case(rp, name):
    """Each sharded spectral norm applied once in train mode to its
    weight, at the seed's weights: its sigma, and its ``_u`` / ``_v``
    after the power step."""
    G, D = build_models(Config(**CASES[name], model_devices=MODEL), rp)
    out = {}
    for tag, net in (("G", G), ("D", D)):
        for mname, m in net.named_modules():
            if isinstance(m, tp.ShardedSpectralNorm):
                out[f"{tag}.{mname}"] = _sn_apply(m, _weight_of(net, mname))
    return out


def _weight_of(net, sn_name):
    """The original weight a spectral norm module (``...weight.0``)
    normalizes."""
    return net.get_submodule(sn_name[:-len(".0")]).original


def _sn_apply(m, w):
    with torch.no_grad():
        m.train()
        wn = m(w)
        i = int(w.abs().argmax())
        return {"sigma": (w.flatten()[i] / wn.flatten()[i]).item(),
                "u": m._u.clone(), "v": m._v.clone()}


def _wait_for(path):
    """``path`` once the test process has written it."""
    deadline = time.monotonic() + JOIN_TIMEOUT
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.05)
    return path


def rank_cases(rp, tmp, data):
    """Every case's TP side, then each data group's share of the cases
    without a model axis (the data group alone: the floor); writes
    ``rank{r}.pt``."""
    torch.set_num_threads(1)
    out = {}
    data_only = dist.Replicas(rank=rp.data_rank, world=rp.data_world,
                              group=rp.data_group)
    for name, kw in CASES.items():
        out[name] = full_summary(run_step(
            Config(**kw, model_devices=MODEL), rp), rp)
    out["sn"] = {name: sn_case(rp, name) for name in SN_CASES}
    ckpt_case(rp, tmp, data)
    out["replicas"] = replica_case(rp)
    # each data group runs a share of the cases without a model axis
    out["dp"] = {name: summary(run_step(Config(**CASES[name]), data_only))
                 for name in list(CASES)[rp.model_rank::MODEL]}
    # the JAX comparison's inputs, written by the test process meanwhile
    jax_in = torch.load(_wait_for(os.path.join(tmp, JAX_IN)),
                        weights_only=False)
    out["jax"] = full_summary(run_step(
        Config(**JAX_CASE, model_devices=MODEL), rp,
        weights=jax_in["weights"], noises=jax_in["noises"]), rp)
    torch.save(out, os.path.join(tmp, f"rank{rp.rank}.pt"))


# ---------------------------------------------------------------------------
# this process's side
# ---------------------------------------------------------------------------
def jax_tp_step(gv, dv, key):
    """The JAX Trainer's TP programs (model_devices=2 of 4 virtual
    devices; its split mode, ``fused_step=False``, the D and G programs
    compiled side by side, while the sharded-set cases' trees are traced)
    one step from ``gv``/``dv``: (new state, metrics) as numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gan3d_tpu.config import Config as JConfig
    from gan3d_tpu.models import build_models as jbuild
    from gan3d_tpu.parallel.mesh import make_mesh
    from gan3d_tpu.parallel.tp import count_sharded, tp_shardings
    from gan3d_tpu.train.state import TrainState, make_optimizer
    from gan3d_tpu.train.step import build_split_steps

    jcfg = JConfig(**JAX_CASE, num_devices=4, model_devices=MODEL,
                   fused_step=False)
    mesh = make_mesh(4, model=MODEL)
    G_j, D_j = jbuild(jcfg)
    g_tx = make_optimizer(jcfg.lrG, jcfg.adam_b1, jcfg.adam_b2,
                          mu_free=jcfg.mu_free_adam)
    d_tx = make_optimizer(jcfg.lrD, jcfg.adam_b1, jcfg.adam_b2,
                          mu_free=jcfg.mu_free_adam)
    split = lambda v: (v["params"],  # noqa: E731
                       {k: x for k, x in v.items() if k != "params"})
    gp, gs = split(gv)
    dp, ds = split(dv)

    def fresh(tx, params):  # Adam's initial state (zeros), not run eagerly
        return jax.tree.map(lambda x: np.zeros(x.shape, x.dtype),
                            jax.eval_shape(tx.init, params))

    state = TrainState(step=jnp.int32(0), g_params=gp, g_state=gs,
                       g_opt=fresh(g_tx, gp), d_params=dp, d_state=ds,
                       d_opt=fresh(d_tx, dp))
    shard = tp_shardings(state, mesh)
    assert count_sharded(shard) > 0
    rep = NamedSharding(mesh, P())
    rows = NamedSharding(mesh, P("data"))
    d_fn, g_fn = build_split_steps(jcfg, G_j, D_j, g_tx, d_tx)
    d_jit = jax.jit(d_fn, in_shardings=(shard, rows, rep, rep),
                    out_shardings=(shard, rep))
    g_jit = jax.jit(g_fn, in_shardings=(shard, rep),
                    out_shardings=(shard, rep, rows))
    reals = jnp.asarray(np.moveaxis(reals_for(Config(**JAX_CASE)).numpy(),
                                    2, -1))
    state = jax.device_put(state, shard)
    lowered = (d_jit.lower(state, reals[0], key, jnp.int32(0)),
               g_jit.lower(state, key))
    with ThreadPoolExecutor(max_workers=2) as pool:
        compiled = [pool.submit(lo.compile) for lo in lowered]
        for name in RULE_CASES:  # traced while XLA compiles
            _jax_trees(name)
        d_step, g_step = (c.result() for c in compiled)
    metrics = {}
    for k in range(JAX_CASE["iterD"]):
        state, metrics = d_step(state, reals[k], key, jnp.int32(k))
    state, g_metrics, _ = g_step(state, key)
    return (jax.tree.map(np.array, state),
            {k: float(v) for k, v in {**metrics, **g_metrics}.items()})


def _spread(a, b):
    """Per update and tensor, the largest difference of two runs'
    gradients."""
    return {w: [[(x - y).abs().max().item() for x, y in zip(us, vs)]
                for us, vs in zip(a[f"{w}_grads"], b[f"{w}_grads"])]
            for w in "gd"}


def one_process_refs(names):
    """The one-process step of each of ``names``, and for FLOOR_CASES the
    spread of the same step at FLOOR_THREADS threads: ({name: summary},
    {name: spread})."""
    refs, floors = {}, {}
    for name in names:
        cfg = Config(**CASES[name])
        refs[name] = summary(run_step(cfg))
        if name in FLOOR_CASES:
            torch.set_num_threads(FLOOR_THREADS)
            try:
                floors[name] = _spread(refs[name], summary(run_step(cfg)))
            finally:
                torch.set_num_threads(1)
    return refs, floors


_TREES_LOCK = threading.Lock()


def _jax_trees(name):
    """(the JAX G and D of RULE_CASES[name], the shapes of their init's
    variables), traced once for the threads that ask."""
    with _TREES_LOCK:
        return _trace_trees(name)


@functools.lru_cache(maxsize=None)
def _trace_trees(name):
    import jax
    import jax.numpy as jnp
    from gan3d_tpu.config import Config as JConfig
    from gan3d_tpu.models import build_models as jbuild

    kw = RULE_CASES[name]
    G_j, D_j = jbuild(JConfig(**kw))
    r = kw["resolution"]
    rngs = {"params": jax.random.key(0), "noise": jax.random.key(1)}
    g = jax.eval_shape(G_j.init, rngs, jnp.zeros((2, kw["z_size"])))
    d = jax.eval_shape(D_j.init, {"params": jax.random.key(0)},
                       jnp.zeros((2, r, r, r, 1)))
    return G_j, D_j, g, d


def _jax_noise(key):
    """The noise JAX_CASE's fused step draws at step 0 (test_torch_step.
    jax_noise's keys, in one jitted program)."""
    import jax
    from gan3d_tpu.utils.prng import fold_step

    b, z, n = JAX_CASE["batch_size"], JAX_CASE["z_size"], JAX_CASE["iterD"]

    def draw(base):
        key = fold_step(base, 0)
        keys = [jax.random.split(jax.random.fold_in(key, i), 4)[0]
                for i in range(n)]
        keys.append(jax.random.split(jax.random.fold_in(key, 1000))[0])
        return [jax.random.normal(k, (b, z)) for k in keys]

    return [np.array(x) for x in jax.jit(draw)(key)]


def jax_side(tmp):
    """Random JAX trees of JAX_CASE's structure (test_torch_dp.py's fill)
    and the JAX step's noise, written for the ranks (``JAX_IN``); then
    the JAX TP step on them."""
    import jax

    from test_torch_dp import random_variables

    from gan3d_tpu_torch import convert

    _, _, g, d = _jax_trees("flagship")
    rng = np.random.default_rng(4)
    gv, dv = random_variables(g, rng), random_variables(d, rng)
    cfg = Config(**JAX_CASE)
    key = jax.random.key(5)
    jax_in = {"weights": (convert.from_jax_variables(gv, cfg, "g"),
                          convert.from_jax_variables(dv, cfg, "d")),
              "noises": [torch.from_numpy(n) for n in _jax_noise(key)]}
    torch.save(jax_in, os.path.join(tmp, JAX_IN + ".tmp"))
    os.replace(os.path.join(tmp, JAX_IN + ".tmp"), os.path.join(tmp, JAX_IN))
    return jax_tp_step(gv, dv, key)


def one_process_side(tmp, data):
    """The one-process checkpoint the ranks resume (its copies, then
    ``ONE_READY``), then ``one_process_refs`` of every case."""
    _train(Config(**CKPT, data_path=data, log_dir=str(tmp / "one_run")))
    for d in ("one_for_tp", "one_for_one"):
        shutil.copytree(tmp / "one_run", tmp / d)
    (tmp / ONE_READY).touch()
    return one_process_refs(list(CASES))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the four ranks, the JAX side, the one-process checkpoint the
    ranks resume and the one-process steps; returns a function that
    waits for them:
    (every rank's results, the JAX result, the one-process refs and
    floors, the output directory, the data)."""
    from gan3d_tpu.ops.attention import set_attention_impl

    tmp = tmp_path_factory.mktemp("tp")
    data = str(tmp / "train.npz")
    np.savez(data, X=np.tanh(np.random.default_rng(0).normal(
        size=(8, 16, 16, 16))).astype(np.float32))
    plan = dist.Plan(world=WORLD, local=WORLD, first=0, device="cpu",
                     model=MODEL)
    pool = ThreadPoolExecutor(max_workers=3)
    # the lowering the JAX Trainer sets for a sharded program
    set_attention_impl("xla")
    jax_done = pool.submit(jax_side, str(tmp))
    ranks_done = pool.submit(dist.launch, rank_cases, (str(tmp), data),
                             plan, JOIN_TIMEOUT)
    # one thread for everything that builds torch models here: their
    # seeded init forks the global RNG
    one_done = pool.submit(one_process_side, tmp, data)
    state = {"dp": {}}

    def wait():
        if "r" not in state:
            ranks_done.result()
            state["r"] = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                          for r in range(WORLD)]
            state["jax"] = jax_done.result()
            state["refs"] = one_done.result()
            for r in state["r"][:MODEL]:  # one rank of each data group
                state["dp"].update(r["dp"])
        return (state["r"], state["jax"], state["refs"] + (state["dp"],),
                tmp, data)

    try:
        yield wait
    finally:
        pool.shutdown(wait=True)
        set_attention_impl(None)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------
def check_like_one_process(got, want, floor=None, stateful=True):
    """test_torch_dp.check_like_one_process with the floor: a tensor's
    error within its tolerances or within FLOOR_X times the one-process
    step's own spread (``one_process_refs``)."""
    for k in ("d_real", "d_fake", "g_loss"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got["pl_mean"], want["pl_mean"],
                               rtol=LOSS_RTOL, atol=0)
    n_state = 0
    for w in ("g", "d"):
        names = want[f"{w}_names"]
        big = {}
        assert len(got[f"{w}_grads"]) == len(want[f"{w}_grads"])
        for u, (gs, ws) in enumerate(zip(got[f"{w}_grads"],
                                         want[f"{w}_grads"])):
            zero = ZERO * max(g1.abs().max().item() for g1 in ws)
            for i, (name, g, g1) in enumerate(zip(names, gs, ws)):
                top = g1.abs().max().item()
                if top <= zero:
                    assert g.abs().max().item() <= zero, (w, name)
                    big[name] = torch.zeros_like(g1, dtype=torch.bool)
                    continue
                err = (g - g1).abs().max().item()
                spread = 0.0 if floor is None else floor[w][u][i]
                assert err <= max(GRAD_TOL * zero / ZERO, FLOOR_X * spread), (
                    w, name, err, zero, spread)
                assert err <= max(OWN_TOL * top, FLOOR_X * spread), (
                    w, name, err, top, spread)
                above = g1.abs() > max(GRAD_TOL * zero / ZERO,
                                       OWN_TOL * top, FLOOR_X * spread,
                                       1e-6)
                big[name] = big.get(name, above) & above
        for name in names:
            mask = big[name]
            torch.testing.assert_close(got[f"{w}_sd"][name][mask],
                                       want[f"{w}_sd"][name][mask],
                                       rtol=1e-4, atol=1e-7,
                                       msg=f"{w} {name}")
        for key, value in want[f"{w}_sd"].items():
            if key.endswith(("running_mean", "running_var", "._u", "._v")):
                np.testing.assert_allclose(got[f"{w}_sd"][key].numpy(),
                                           value.numpy(), **STATE_TOL,
                                           err_msg=f"{w} {key}")
                n_state += 1
    assert (n_state > 0) == stateful


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_one_process(ranks, name):
    cfg = Config(**CASES[name])
    rs, _, (refs, floors, dp), _, _ = ranks()
    want = refs[name]
    assert rs[0][name]["g_plan"] and rs[0][name]["d_plan"]
    # the floor: the larger of the thread count's spread and the data
    # split's
    floor = _spread(want, dp[name])
    for w, spreads in floors.get(name, {}).items():
        floor[w] = [[max(x, y) for x, y in zip(us, vs)]
                    for us, vs in zip(floor[w], spreads)]
    check_like_one_process(rs[0][name], want, floor,
                           cfg.family() not in ("stylegan", "stylegan2"))
    # every rank holds the same whole state
    for r in rs[1:]:
        for w in ("g_sd", "d_sd"):
            for k, v in rs[0][name][w].items():
                assert torch.equal(v, r[name][w][k]), (name, w, k, r)


@pytest.mark.parametrize("name", SN_CASES)
def test_spectral_norm_on_shards_matches_one_process(ranks, name):
    """Each sharded spectral norm applied once at the seed's weights:
    sigma, u and v against one process's, 1e-5; u and v after the step
    are held by test_tp_step_matches_one_process."""
    rs, _, _, _, _ = ranks()
    got = rs[0]["sn"][name]
    assert got
    G, D = build_models(Config(**CASES[name]))
    nets = {"G": G, "D": D}
    for key, g in got.items():
        tag, mname = key.split(".", 1)
        net = nets[tag]
        want = _sn_apply(net.get_submodule(mname), _weight_of(net, mname))
        np.testing.assert_allclose(g["sigma"], want["sigma"], rtol=1e-5,
                                   atol=0, err_msg=key)
        for vec in ("u", "v"):
            np.testing.assert_allclose(g[vec].numpy(), want[vec].numpy(),
                                       atol=1e-5, rtol=0, err_msg=key + vec)


def test_tp_step_matches_jax_trainer(ranks):
    """Rank 0's step against the JAX TP program's; the gradient magnitudes
    through Adam's nu and the parameters where every update's gradient is
    above the tolerance (test_torch_dp.test_dcgan_dp_step_matches_jax_
    trainer's scheme); the losses at test_tp.py's 5e-3."""
    from gan3d_tpu_torch import convert

    rs, (new, metrics), _, _, _ = ranks()
    got = rs[0]["jax"]
    cfg = Config(**JAX_CASE)
    assert got["g_plan"]
    for k in ("d_real", "d_fake", "g_loss"):
        np.testing.assert_allclose(got["metrics"][k], metrics[k], rtol=5e-3,
                                   atol=5e-3, err_msg=k)
    for w, params, st, jopt in (
            ("g", new.g_params, new.g_state, new.g_opt),
            ("d", new.d_params, new.d_state, new.d_opt)):
        want = convert.from_jax_variables({"params": params, **st}, cfg, w)
        nu = convert.from_jax_variables({"params": jopt[0].nu, **st}, cfg, w)
        weight = 1.0 - 0.9 ** int(jopt[0].count)
        for i, (name, nu_t) in enumerate(zip(got[f"{w}_names"],
                                             got[f"{w}_nu"])):
            g_j = np.sqrt(nu[name].numpy() / weight)
            g_t = np.sqrt(nu_t.numpy() / weight)
            if g_j.max() <= 1e-4:  # a conv bias that feeds a BN
                assert g_t.max() <= 1e-4, (w, name, g_t.max())
                continue
            np.testing.assert_allclose(g_t, g_j, rtol=0,
                                       atol=5e-3 * g_j.max(),
                                       err_msg=f"{w} |grad| {name}")
            mask = np.logical_and.reduce([
                np.abs(gs[i].numpy()) > max(1e-6, 5e-3 * g_j.max())
                for gs in got[f"{w}_grads"]])
            np.testing.assert_allclose(got[f"{w}_sd"][name].numpy()[mask],
                                       want[name].numpy()[mask], rtol=1e-4,
                                       atol=1e-7, err_msg=f"{w} {name}")
        for key, value in want.items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[f"{w}_sd"][key].numpy(),
                                           value.numpy(), **STATE_TOL,
                                           err_msg=f"{w} {key}")


def _same_checkpoint(a, b):
    """Two checkpoints of one state: the parameters and Adam's moments
    bit-equal, the BN and SN state within STATE_TOL."""
    assert a["step"] == b["step"]
    for k in ("modelG_state_dict", "modelD_state_dict"):
        assert a[k].keys() == b[k].keys()
        for key, v in a[k].items():
            if key.endswith(("running_mean", "running_var", "._u", "._v")):
                np.testing.assert_allclose(v.numpy(), b[k][key].numpy(),
                                           **STATE_TOL, err_msg=key)
            else:
                assert torch.equal(v, b[k][key]), (k, key)
    for k in ("optimizerG_state_dict", "optimizerD_state_dict"):
        assert a[k]["count"] == b[k]["count"]
        for x, y in zip(a[k]["nu"], b[k]["nu"]):
            assert torch.equal(x, y), k


@pytest.mark.parametrize("direction", ["one_to_tp", "tp_to_one"])
def test_checkpoint_moves_between_tp_and_one_process(ranks, direction,
                                                     capsys):
    """A one-process checkpoint resumed at data 2 x model 2, and a TP
    run's resumed in one process, each against the other kind resuming
    the same file; a TP checkpoint is the one-process layout (loads
    strictly into one process's networks)."""
    _, _, _, tmp, data = ranks()
    cfg = Config(**CKPT, data_path=data)
    if direction == "one_to_tp":
        _train(cfg.replace(log_dir=str(tmp / "one_for_one")))
        assert "starting from step 1" in capsys.readouterr().out
        _same_checkpoint(_ckpt(tmp / "one_for_tp"), _ckpt(tmp / "one_for_one"))
    else:
        shutil.copytree(tmp / "tp_run", tmp / "tp_for_one")
        _train(cfg.replace(log_dir=str(tmp / "tp_for_one")))
        assert "starting from step 1" in capsys.readouterr().out
        _same_checkpoint(_ckpt(tmp / "tp_for_tp"), _ckpt(tmp / "tp_for_one"))
        G, D = build_models(cfg)
        G.load_state_dict(_ckpt(tmp / "tp_run")["modelG_state_dict"])
        D.load_state_dict(_ckpt(tmp / "tp_run")["modelD_state_dict"])


def test_replica_check_fails_on_a_changed_shard(ranks):
    rs, _, _, _, _ = ranks()
    for r in rs:
        assert r["replicas"]["n"] == 2
        assert "1 tensors differ" in r["replicas"]["caught"]


@pytest.mark.parametrize("case", ["spatial_and_model", "world",
                                  "batch"])
def test_grid_errors(tmp_path, case):
    from gan3d_tpu_torch.data import open_dataset
    from gan3d_tpu_torch.train.trainer import Trainer

    if case == "spatial_and_model":
        with pytest.raises(ValueError, match="cannot be combined"):
            dist.plan(4, "cpu", model_devices=2, spatial_devices=2)
        with pytest.raises(ValueError, match="cannot be combined"):
            Trainer(None, Config(**BASE, platform="cpu", model_devices=2,
                                 spatial_devices=2,
                                 log_dir=str(tmp_path / "run")))
    elif case == "world":
        with pytest.raises(ValueError, match="3 devices not divisible by 2"):
            dist.plan(3, "cpu", model_devices=2)
        assert dist.plan(4, "cpu", model_devices=2).model == 2
    else:
        path = str(tmp_path / "d.npz")
        np.savez(path, X=np.zeros((4, 16, 16, 16), np.float32))
        cfg = Config(**dict(BASE, batch_size=3), platform="cpu",
                     num_devices=WORLD, model_devices=MODEL,
                     log_dir=str(tmp_path / "run"))
        with pytest.raises(ValueError, match="not divisible by 2 data"):
            Trainer(open_dataset(path), cfg, _fake_grid())


def _marker_plan(name, which, shapes):
    """The port's names of the leaves JAX's ``tp_shardings`` shards in
    ``shapes`` (a network's variables), read through
    ``convert.from_jax_variables`` of a marker fill."""
    import jax
    from gan3d_tpu.parallel.mesh import make_mesh
    from gan3d_tpu.parallel.tp import tp_shardings

    from gan3d_tpu_torch import convert

    sh = tp_shardings(shapes, make_mesh(4, model=MODEL))

    def mark(s, leaf):
        return np.full(leaf.shape, 1.0 if "model" in str(s.spec) else 0.0,
                       np.float32)

    sd = convert.from_jax_variables(jax.tree.map(mark, sh, shapes),
                                    Config(**RULE_CASES[name]), which)
    return {k for k, v in sd.items()
            if v.numel() and v.is_floating_point() and bool((v == 1).all())}


@pytest.mark.parametrize("name", list(RULE_CASES))
def test_sharded_set_matches_jax_rule(ranks, name):
    """(Last in the module, after ``ranks``: the JAX trees come from the
    fixture's JAX side, and no other thread builds a model meanwhile.)"""
    ranks()
    import jax
    import jax.numpy as jnp
    from gan3d_tpu.config import Config as JConfig
    from gan3d_tpu.parallel.mesh import make_mesh
    from gan3d_tpu.parallel.tp import count_sharded, tp_shardings
    from gan3d_tpu.train.state import TrainState, make_optimizer

    from gan3d_tpu_torch.nn.attention import SelfAttention3d
    from gan3d_tpu_torch.train.state import Adam

    kw = RULE_CASES[name]
    cfg = Config(**kw, model_devices=MODEL)
    G, D = build_models(cfg, _fake_grid())
    _, _, g, d = _jax_trees(name)
    for which, net, shapes in (("g", G, g), ("d", D, d)):
        assert net.tp_plan
        assert set(net.tp_plan) == _marker_plan(name, which, shapes), which
    if name == "dcgan_sagan":  # the JAX quirk followed: sharded attention
        attn = [n for n, m in D.named_modules()
                if isinstance(m, SelfAttention3d)]
        assert attn and any(k.startswith(attn[0] + ".")
                            for k in D.tp_plan)
    # the train state's shards: the parameters', Adam's moments', the EMA's
    opts = [Adam(net.parameters(), cfg.lrG, cfg.adam_b1, cfg.adam_b2,
                 mu_free=cfg.mu_free_adam) for net in (G, D)]
    n_port = sum(tp.sharded(p) * (1 + 1 + (opt.mu is not None))
                 for opt in opts for p in opt.params)
    if cfg.family() == "stylegan2":
        n_port += sum(tp.sharded(p) for p in G.parameters())
    jcfg = JConfig(**kw)
    tx = make_optimizer(jcfg.lrG, jcfg.adam_b1, jcfg.adam_b2,
                        mu_free=jcfg.mu_free_adam)
    split = lambda v: (v["params"],  # noqa: E731
                       {k: x for k, x in v.items() if k != "params"})
    gp, gs = split(g)
    dp, ds = split(d)
    state = TrainState(
        step=jax.ShapeDtypeStruct((), jnp.int32), g_params=gp, g_state=gs,
        g_opt=jax.eval_shape(tx.init, gp), d_params=dp, d_state=ds,
        d_opt=jax.eval_shape(tx.init, dp),
        ema_params=gp if jcfg.family() == "stylegan2" else None,
        pl_mean=jax.ShapeDtypeStruct((), jnp.float32))
    n_jax = count_sharded(tp_shardings(state, make_mesh(4, model=MODEL)))
    assert n_port == n_jax > 0

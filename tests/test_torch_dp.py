"""Data parallelism (gan3d_tpu_torch/parallel/) on the CPU: two gloo ranks
against the port's one-process run on the global batch, and the DCGAN
family's step against the JAX package's Trainer with num_devices=2.

One spawn for the module: the fixture ``ranks`` starts two gloo ranks
(``parallel.launch``, the train CLI's launcher; joined within 50 s) that
run the data-parallel side of every case and write what each case reads
(``rank_cases``); meanwhile this process runs the one-process side and,
in worker threads, the JAX Trainer's steps. Each case is then asserted
in its own test. Cases and tolerances:

- BatchNorm's grouped scope against the JAX ``BatchNorm3d(3,
  num_groups=2)``: the output and the running stats, 1e-5 (as
  tests/test_sync_bn.py:12-30 holds the JAX one against its halves);
- BatchNorm's cross-replica scope, each rank half the batch, against one
  process on the whole batch: the output, the input's gradient, the
  scale's and bias's gradients (summed over ranks) and the running
  stats, 1e-6;
- one step of each family at 2 ranks (16^3, or 8^3 for the StyleGAN
  families; filters 8, or 16 for StyleGAN; batch 4, or 8 for StyleGAN2;
  f32) against the port's one-process step on the global batch, with the
  same seed and generator: the losses to rtol 1e-5; every all-reduced
  gradient taken before Adam to 1e-5 of the update's largest gradient
  and to 1e-4 of its own tensor's largest value (a sum with cancellation
  is not reproducible to 1e-5 of its own size in f32: the one-process
  step alone moves a G BN scale's gradient by 1.2e-5 of itself between 1
  and 6 threads, the rank split by 3.2e-5, and StyleGAN D's output bias,
  a sum of +-0.5 terms, by 4.8e-5); a tensor below 1e-6 of the update's
  largest gradient (a conv bias that feeds a BN) is zero up to rounding
  and must stay below it; the parameters where every update's gradient
  is above those tolerances (with b1 = 0 an update is ~lr * sign(g):
  test_torch_step.py's scheme) to rtol 1e-4 / atol 1e-7, every BN
  running stat and SN vector to atol 1e-5 / rtol 1e-4
  (test_torch_step.py's), StyleGAN's pl_mean to rtol 1e-5.
  The configurations: the flagship's flags (at 16^3 its G and D have no
  attention), ``--dcgan --msl``, ``--dcgan --gp_weight=10``, the hybrid,
  StyleGAN2 on its lazy step 0 with ``sg2_reg_grads`` (R1 through the
  minibatch-std gather, the path-length rows [0, 4) all on rank 0),
  StyleGAN-1 (the mixing permutes the global batch), and
  ``--sync_bn=False`` against a one-process step whose BN has
  ``num_groups=2``;
- the DCGAN family's step (WGAN-LN D, 16^3, batch 4) at 2 ranks with
  ``sync_bn`` True and False against the JAX Trainer with
  ``num_devices=2`` on the virtual CPU mesh (tests/conftest.py), weights
  carried over with ``convert.from_jax_variables`` (random trees of the
  JAX modules' structure, ``jax.eval_shape`` of the init and a numpy
  fill, as test_torch_step.py makes them) and the JAX step's noise
  injected, by test_torch_step.py's scheme and tolerances;
- the replica check failing on both ranks once rank 1 holds a changed
  tensor (the trainer's check after its steps, and the train CLI's rank
  entry point: test_torch_dp_eval.py);
- the repairs: ``num_devices=0`` means every visible card (a
  monkeypatched count), a count above the visible cards raises, and the
  Trainer refuses a multi-rank config without a process group.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models import build_models
from gan3d_tpu_torch.models.stylegan import loss as sg_loss
from gan3d_tpu_torch.nn.norm import BatchNorm3d
from gan3d_tpu_torch.parallel import dist
from gan3d_tpu_torch.train.state import Adam
from gan3d_tpu_torch.train.step import train_step

torch.set_num_threads(1)

WORLD = 2
JOIN_TIMEOUT = 50.0
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5   # of the update's largest gradient
OWN_TOL = 1e-4    # of the tensor's own largest gradient
STATE_TOL = dict(atol=1e-5, rtol=1e-4)
# a gradient tensor whose largest entry is below this share of the
# update's largest is zero up to rounding in both runs
ZERO = 1e-6

BASE = dict(resolution=16, filterG=8, filterD=8, z_size=8, batch_size=4,
            iterD=2, compute_dtype="float32")
SG = dict(resolution=8, filterG=16, filterD=16, z_size=8, iterD=2,
          compute_dtype="float32")
CASES = {
    "flagship": dict(BASE, biggan=True, hinge=True),
    "dcgan_msl": dict(BASE, dcgan=True, msl=True),
    "dcgan_gp": dict(BASE, dcgan=True, gp_weight=10.0),
    "hybrid": dict(BASE, hybrid=True, biggan=True),
    "stylegan2": dict(SG, stylegan2=True, batch_size=8, sg2_reg_grads=True),
    "stylegan1": dict(SG, stylegan=True, batch_size=4),
    "sync_bn_off": dict(BASE, biggan=True, hinge=True, sync_bn=False),
}
DCGAN = dict(BASE, dcgan=True, hinge=False)


class RecAdam(Adam):
    """Adam that keeps every gradient list it is given."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.seen = []

    def step(self, grads):
        self.seen.append([g.detach().clone() for g in grads])
        super().step(grads)


def reals_for(cfg, seed=3):
    r = cfg.resolution
    x = np.random.default_rng(seed).normal(
        size=(cfg.iterD, cfg.batch_size, 1, r, r, r))
    return torch.from_numpy(np.tanh(x).astype(np.float32))


def run_step(cfg, replicas=None, groups=1, weights=None, noises=None):
    """Step 0 of ``cfg``'s family from its seeded weights (or ``weights``:
    G's and D's state dicts), reals from ``reals_for`` (the rank's rows of
    them), the draws from a seeded generator (or ``noises``); BN with
    ``groups`` groups. Returns the models, optimizers, metrics and
    pl_mean."""
    rp = replicas or dist.ONE
    G, D = build_models(cfg, replicas)
    if weights is not None:
        G.load_state_dict(weights[0])
        D.load_state_dict(weights[1])
    for m in G.modules():
        if isinstance(m, BatchNorm3d):
            m.num_groups = groups
    G.train()
    D.train()
    g_opt = RecAdam(G.parameters(), cfg.lrG, 0.0, 0.9)
    d_opt = RecAdam(D.parameters(), cfg.lrD, 0.0, 0.9)
    reals = reals_for(cfg)
    reals = reals[:, rp.span(cfg.batch_size)[0]:rp.span(cfg.batch_size)[1]]
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


def summary(run):
    """What a case compares, as plain tensors."""
    return {"metrics": {k: float(v) for k, v in run["metrics"].items()},
            "g_grads": run["g_opt"].seen, "d_grads": run["d_opt"].seen,
            "g_nu": run["g_opt"].nu, "d_nu": run["d_opt"].nu,
            "g_sd": run["G"].state_dict(), "d_sd": run["D"].state_dict(),
            "g_names": [n for n, _ in run["G"].named_parameters()],
            "d_names": [n for n, _ in run["D"].named_parameters()],
            "pl_mean": float(run["pl_mean"])}


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------
def bn_case(rp):
    """Cross-replica BN on this rank's half of a fixed batch."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(1.0, 2.0, size=(8, 3, 4, 4, 4))
                         .astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(8, 3, 4, 4, 4)).astype(np.float32))
    bn = BatchNorm3d(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.5, -1.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    dist.attach(bn, rp)
    xr = rp.rows(x).clone().requires_grad_(True)
    y = bn(xr)
    (y * rp.rows(c)).sum().backward()
    return {"y": y.detach(), "dx": xr.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "mean": bn.running_mean,
            "var": bn.running_var}


def replica_case(rp):
    """The replica check on tensors that agree, then with rank 1's first
    one changed (the trainer's check after training:
    test_torch_dp_eval.py)."""
    tensors = [torch.arange(6.0), torch.zeros(2, dtype=torch.long)]
    n = rp.check(tensors)
    if rp.rank == 1:
        tensors[0][3] += 1e-3
    try:
        rp.check(tensors)
        caught = ""
    except RuntimeError as e:
        caught = str(e)
    return {"n": n, "caught": caught}


def rank_cases(rp, out_dir, jax_in):
    """Every case's data-parallel side; writes ``rank{r}.pt``."""
    torch.set_num_threads(1)
    out = {"bn": bn_case(rp)}
    for name, kw in CASES.items():
        out[name] = summary(run_step(Config(**kw), rp))
    for sync in (True, False):
        out[f"jax_{sync}"] = summary(run_step(
            Config(**DCGAN, sync_bn=sync), rp, weights=jax_in["weights"],
            noises=jax_in["noises"]))
    out["replicas"] = replica_case(rp)
    torch.save(out, os.path.join(out_dir, f"rank{rp.rank}.pt"))


# ---------------------------------------------------------------------------
# the fixture: the ranks in a thread, the JAX Trainer in another
# ---------------------------------------------------------------------------
def jax_noise(base_key):
    """The noise the JAX fused step draws at step 0 for DCGAN (iterD
    [B, z] arrays for the D updates, one for the G update;
    gan3d_tpu/train/step.py:57-58, 98-99, 132-137; as
    test_torch_step.jax_noise)."""
    import jax
    from gan3d_tpu.utils.prng import fold_step

    key = fold_step(base_key, 0)
    keys = [jax.random.split(jax.random.fold_in(key, i), 4)[0]
            for i in range(DCGAN["iterD"])]
    keys.append(jax.random.split(jax.random.fold_in(key, 1000))[0])
    return [np.array(jax.random.normal(k, (DCGAN["batch_size"],
                                           DCGAN["z_size"])))
            for k in keys]


def _jax_modes():
    """The JAX package's lowering globals, which its Trainer sets."""
    import importlib

    mods = ["gan3d_tpu.ops." + m for m in (
        "attention", "downsample_conv", "dw_conv", "lane_conv", "s2d_conv",
        "subpixel_conv", "tap_conv", "upsample_conv", "wide_conv",
        "c1_conv", "conv3d", "dx_conv")]
    mods += ["gan3d_tpu.models.stylegan.resample",
             "gan3d_tpu.models.stylegan.stylegan1"]
    saved = []
    for name in mods:
        mod = importlib.import_module(name)
        saved += [(mod, k, v) for k, v in vars(mod).items()
                  if k.startswith("_") and (k.endswith("MODE")
                                            or k == "_FORCE_IMPL")]
    return saved


def random_variables(shapes, rng):
    """A random tree of ``shapes``' structure (test_torch_step.py's fill:
    N(0, 0.1) leaves, BN var and scale near 1)."""
    import jax

    def fill(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        x = rng.normal(size=leaf.shape) * 0.1
        if names[-1] in ("var", "scale"):
            x = 1.0 + np.abs(x) if names[-1] == "var" else 1.0 + x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_trainer_step(tmp, data, gv, dv, sync):
    """The JAX Trainer (num_devices=2) one step from ``gv``/``dv`` with
    ``sync_bn=sync``: (new state, metrics) as numpy."""
    import jax
    import jax.numpy as jnp
    from gan3d_tpu.config import Config as JConfig
    from gan3d_tpu.data.datasets import open_dataset as jopen
    from gan3d_tpu.train.state import TrainState
    from gan3d_tpu.train.trainer import Trainer as JTrainer

    jcfg = JConfig(**DCGAN, sync_bn=sync, num_devices=2, data_path=data,
                   data_loader_workers=1, log_dir=str(tmp / f"jax_{sync}"))
    tr = JTrainer(jopen(data), jcfg)
    try:
        assert len(tr.mesh.devices.ravel()) == 2
        split = lambda v: (v["params"],  # noqa: E731
                           {k: x for k, x in v.items() if k != "params"})
        gp, gs = split(gv)
        dp, ds = split(dv)
        state = TrainState(step=jnp.int32(0), g_params=gp, g_state=gs,
                           g_opt=tr.g_tx.init(gp), d_params=dp, d_state=ds,
                           d_opt=tr.d_tx.init(dp))
        state = jax.device_put(state, tr._state_shard)
        reals = jax.device_put(jnp.asarray(np.moveaxis(
            reals_for(Config(**DCGAN)).numpy(), 2, -1)), tr._batch_in)
        new, metrics, _ = tr._step(state, reals, jax.random.key(5), 0)
        return (jax.tree.map(np.array, new),
                {k: float(v) for k, v in metrics.items()})
    finally:
        tr.loader.close()


def one_process_refs():
    """The one-process side of the BN case and of every step case."""
    refs = {"bn": bn_case(dist.ONE)}
    for name, kw in CASES.items():
        cfg = Config(**kw)
        refs[name] = summary(run_step(cfg, groups=1 if cfg.sync_bn else 2))
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the two ranks and the JAX steps; returns a function that
    waits for them: (rank 0's results, rank 1's, the JAX results, the
    output directory)."""
    import jax
    from gan3d_tpu.config import Config as JConfig
    from gan3d_tpu.models import build_models as jbuild
    from gan3d_tpu_torch import convert

    tmp = tmp_path_factory.mktemp("dp")
    data = str(tmp / "train.npz")  # the JAX Trainer's loader reads it
    np.savez(data, X=np.tanh(np.random.default_rng(0).normal(
        size=(8, 16, 16, 16))).astype(np.float32))
    G_j, D_j = jbuild(JConfig(**DCGAN))
    rng = np.random.default_rng(4)
    gv = random_variables(jax.eval_shape(
        G_j.init, {"params": jax.random.key(0)}, np.zeros((2, 8))), rng)
    dv = random_variables(jax.eval_shape(
        D_j.init, {"params": jax.random.key(0)},
        np.zeros((2, 16, 16, 16, 1))), rng)
    cfg = Config(**DCGAN)
    jax_in = {"weights": (convert.from_jax_variables(gv, cfg, "g"),
                          convert.from_jax_variables(dv, cfg, "d")),
              "noises": [torch.from_numpy(n)
                         for n in jax_noise(jax.random.key(5))]}
    plan = dist.Plan(world=WORLD, local=WORLD, first=0, device="cpu")
    pool = ThreadPoolExecutor(max_workers=4)
    ranks_done = pool.submit(dist.launch, rank_cases, (str(tmp), jax_in),
                             plan, JOIN_TIMEOUT)
    saved = _jax_modes()
    jax_done = {sync: pool.submit(jax_trainer_step, tmp, data, gv, dv, sync)
                for sync in (True, False)}
    refs_done = pool.submit(one_process_refs)
    state = {}

    def wait():
        if not state:
            ranks_done.result()
            state["r"] = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                          for r in range(WORLD)]
            state["jax"] = {k: f.result() for k, f in jax_done.items()}
            state["refs"] = refs_done.result()
        return state["r"][0], state["r"][1], state["jax"], state["refs"], tmp

    try:
        yield wait
    finally:
        pool.shutdown(wait=True)
        for mod, k, v in saved:
            setattr(mod, k, v)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------
def check_like_one_process(got, want, stateful=True):
    """``got`` (rank 0's summary) against ``want`` (the one-process run's):
    the module docstring's scheme."""
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
        for gs, ws in zip(got[f"{w}_grads"], want[f"{w}_grads"]):
            zero = ZERO * max(g1.abs().max().item() for g1 in ws)
            for name, g, g1 in zip(names, gs, ws):
                top = g1.abs().max().item()
                if top <= zero:
                    # zero up to rounding (a conv bias that feeds a BN)
                    assert g.abs().max().item() <= zero, (w, name)
                    big[name] = torch.zeros_like(g1, dtype=torch.bool)
                    continue
                err = (g - g1).abs().max().item()
                assert err <= GRAD_TOL * zero / ZERO, (w, name, err, zero)
                assert err <= OWN_TOL * top, (w, name, err, top)
                above = g1.abs() > max(GRAD_TOL * zero / ZERO,
                                       OWN_TOL * top, 1e-6)
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


def test_grouped_bn_matches_jax():
    import jax
    import jax.numpy as jnp
    from gan3d_tpu.nn.norm import BatchNorm3d as JBatchNorm3d

    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, size=(8, 3, 4, 4, 4)).astype(np.float32)
    x[4:] *= 3.0  # the halves' statistics differ
    jbn = JBatchNorm3d(3, num_groups=2)
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    # jitted: one compile each, where eager dispatch compiles every op
    v = jax.jit(jbn.init)(jax.random.key(0), xj)
    y_j, upd = jax.jit(lambda v, xj: jbn.apply(
        v, xj, mutable=["batch_stats"]))(v, xj)
    bn = BatchNorm3d(3, num_groups=2)
    y = bn(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(np.moveaxis(y, 1, -1), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5, atol=1e-5)
    # and it is not the whole batch's normalization
    assert not np.allclose(y, BatchNorm3d(3)(torch.from_numpy(x))
                           .detach().numpy(), atol=1e-3)


def test_cross_replica_bn_matches_one_process(ranks):
    r0, r1, _, refs, _ = ranks()
    want = refs["bn"]
    got = [r0["bn"], r1["bn"]]
    tol = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([g["y"] for g in got]), want["y"],
                               **tol)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got]),
                               want["dx"], **tol)
    for k in ("dw", "db"):
        torch.testing.assert_close(got[0][k] + got[1][k], want[k], **tol)
    for k in ("mean", "var"):
        torch.testing.assert_close(got[0][k], want[k], **tol)
        assert torch.equal(got[0][k], got[1][k])


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_one_process(ranks, name):
    cfg = Config(**CASES[name])
    r0, r1, _, refs, _ = ranks()
    want = refs[name]
    check_like_one_process(r0[name], want,
                           cfg.family() not in ("stylegan", "stylegan2"))
    # the ranks hold one replica
    for w in ("g_sd", "d_sd"):
        for k, v in r0[name][w].items():
            assert torch.equal(v, r1[name][w][k]), (name, w, k)


@pytest.mark.parametrize("sync_bn", [True, False])
def test_dcgan_dp_step_matches_jax_trainer(ranks, sync_bn):
    """Rank 0's step against the JAX Trainer's (num_devices=2); the
    gradient magnitudes are compared through Adam's nu, as
    test_torch_step.py does, and the parameters where every update's
    gradient (recorded on the port's side) is above the gradient
    tolerance: an entry whose first D update's gradient is rounding noise
    (~1e-8 here, a LayerNorm bias) takes either sign in either
    framework."""
    from gan3d_tpu_torch import convert

    r0, _, jax_out, _, _ = ranks()
    got = r0[f"jax_{sync_bn}"]
    new, metrics = jax_out[sync_bn]
    cfg = Config(**DCGAN, sync_bn=sync_bn)
    for k in ("d_real", "d_fake", "g_loss"):
        np.testing.assert_allclose(got["metrics"][k], metrics[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
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


def test_replica_check_fails_on_a_changed_tensor(ranks):
    """The check passes on tensors that agree and fails on both ranks once
    rank 1 holds a changed one (the trainer's check after its steps:
    test_torch_dp_eval.py::test_cli_train_and_resume_at_two_ranks)."""
    r0, r1, _, _, _ = ranks()
    assert r0["replicas"]["n"] == r1["replicas"]["n"] == 2
    for r in (r0, r1):
        assert "1 tensors differ from rank 0's" in r["replicas"]["caught"]


@pytest.mark.parametrize("case", ["zero_is_every_card", "too_many_raise",
                                  "cpu", "trainer_needs_a_group"])
def test_num_devices_repairs(monkeypatch, tmp_path, case):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    if case == "zero_is_every_card":
        p = dist.plan(0)
        assert (p.world, p.local, p.device, p.parallel) == (3, 3, "cuda",
                                                            True)
        assert dist.plan(0, distributed=True, coordinator_address="h:1",
                         num_processes=2, process_id=1).first == 3
    elif case == "too_many_raise":
        with pytest.raises(ValueError, match="3 are visible"):
            dist.plan(4)
        with pytest.raises(ValueError, match="distributed"):
            dist.plan(2, distributed=True)
    elif case == "cpu":
        assert not dist.plan(0, "cpu").parallel
        assert dist.plan(4, "cpu").world == 4
    else:
        from gan3d_tpu_torch.data import open_dataset
        from gan3d_tpu_torch.train.trainer import Trainer

        path = str(tmp_path / "d.npz")
        np.savez(path, X=np.zeros((4, 16, 16, 16), np.float32))
        cfg = Config(**CASES["flagship"], log_dir=str(tmp_path / "run"))
        with pytest.raises(ValueError, match="takes 3 ranks"):
            Trainer(open_dataset(path), cfg)

"""The port's fused StyleGAN2 step and trainer against the JAX package's.

One step of ``gan3d_tpu.models.stylegan.loss.build_stylegan_step`` (iterD
2, batch 4, 8^3, filters 16: G channels 4/2, D 2/4) and of the port's
``models/stylegan/loss.train_step`` from the same weights (carried across
with ``from_jax_variables``), reals and draws: at step 0 (lazy R1 and PL
on) and step 1 (off), with ``sg2_reg_grads`` False (penalties as values)
and True (their gradients through a double backward). The JAX step runs
under ``jax.jit`` (the three programs compiled side by side) with its
``jax.random.normal`` / ``randint`` / ``uniform`` draws recorded in call
order and returned from the jitted function; the port's step replays them through ``Draws`` (the PL
synthesis noise, which the JAX step draws twice with one key, once).
Compared afterwards, with ``test_torch_step``'s tolerances:

- the losses (rtol 1e-4) and the G update's image;
- the gradients' magnitudes, from Adam's nu, to 5e-3 of each tensor's
  largest;
- every parameter of G and D where that gradient is above 1e-6 and the
  gradient tolerance (rtol 1e-4 / atol 1e-7), the EMA (equal to G's
  parameters after the fold-back) and ``pl_mean`` (rtol 1e-4).

Then a 2-step CPU run of the train CLI with ``--stylegan2=True`` at 16^3
and a resume to step 3, with the global RNG state unchanged by the runs.
"""

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan3d_tpu.config import Config as JConfig
from gan3d_tpu.models import build_models as jbuild
from gan3d_tpu.models.stylegan.loss import build_stylegan_step
from gan3d_tpu.train.state import TrainState, make_optimizer
from gan3d_tpu_torch import convert
from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models import build_models
from gan3d_tpu_torch.models.stylegan.loss import LAZY_INTERVAL, Draws
from gan3d_tpu_torch.models.stylegan.loss import train_step
from gan3d_tpu_torch.train.state import Adam

from test_torch_step import GRAD_TOL  # noqa: E402
from test_torch_stylegan2 import (captured_draws, ncdhw,  # noqa: E402
                                  sg2_variables)

torch.set_num_threads(1)

_TRACING = threading.Lock()
CFG = dict(stylegan2=True, resolution=8, filterG=16, filterD=16, z_size=8,
           batch_size=4, iterD=2, compute_dtype="float32")


def jax_sg2_step(cfg_kw, step, pl_mean, seed=0):
    """One JAX step from random weights at ``step``: returns (gv, dv,
    reals, the new state, metrics, the G update's image, the draws)."""
    jcfg = JConfig(**cfg_kw)
    R, B = jcfg.resolution, jcfg.batch_size
    G_j, D_j = jbuild(jcfg)
    rng = np.random.default_rng(seed)
    rngs = {"params": jax.random.key(0), "noise": jax.random.key(1)}
    gv = sg2_variables(jax.eval_shape(G_j.init, rngs,
                                      jnp.zeros((B, jcfg.z_size))), rng)
    dv = sg2_variables(jax.eval_shape(D_j.init, rngs,
                                      jnp.zeros((B, R, R, R, 1))), rng)
    reals = np.tanh(rng.normal(size=(jcfg.iterD, B, 1, R, R, R))
                    ).astype(np.float32)
    g_tx = make_optimizer(jcfg.lrG, 0.0, 0.9)
    d_tx = make_optimizer(jcfg.lrD, 0.0, 0.9)
    gp = gv["params"]
    state = TrainState(
        step=jnp.int32(step), g_params=gp, g_state={"moving": gv["moving"]},
        g_opt=g_tx.init(gp), d_params=dv["params"], d_state={},
        d_opt=d_tx.init(dv["params"]),
        ema_params=jax.tree.map(jnp.copy, gp), pl_mean=jnp.float32(pl_mean))
    lazy = step % LAZY_INTERVAL == 0
    fn = build_stylegan_step(jcfg, G_j, D_j, g_tx, d_tx, static_r1=lazy,
                             static_pl=lazy)

    def run(state, reals, key):
        with captured_draws(("normal", "randint", "uniform")) as draws:
            out = fn(state, reals, key)
        return out, draws

    args = (state, jnp.asarray(np.moveaxis(reals, 2, -1)), jax.random.key(5))
    with _TRACING:  # the draws are recorded through module globals
        lowered = jax.jit(run).lower(*args)
    (new, metrics, fake), draws = lowered.compile()(*args)
    to_np = lambda t: jax.tree.map(np.array, t)  # noqa: E731
    return (gv, dv, reals, to_np(new), {k: float(v)
                                        for k, v in metrics.items()},
            np.array(fake), [np.array(d) for d in draws])


def port_draws(draws, n_noise, lazy):
    """The JAX step's draws as the port asks for them: NCDHW noise, and
    the PL synthesis noise once (the JAX step draws it for the image and
    again, with the same key, inside its gradient)."""
    if lazy:
        dup, draws = draws[-n_noise:], draws[:-n_noise]
        for a, b in zip(dup, draws[-n_noise - 1:-1]):
            np.testing.assert_array_equal(a, b)
    return [torch.from_numpy(np.array(ncdhw(d) if d.ndim == 5 else d))
            for d in draws]


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX steps, traced one at a time and compiled side by side in
    worker threads. At step 1 (no penalty) the JAX step does not depend on
    ``sg2_reg_grads``, so both of the port's cases there are held against
    one JAX run."""
    with ThreadPoolExecutor(max_workers=3) as pool:
        runs = {(step, reg): pool.submit(
            jax_sg2_step, dict(CFG, sg2_reg_grads=reg), step, 0.25)
            for step, reg in ((0, False), (0, True), (1, False))}
        runs[1, True] = runs[1, False]
        yield runs


@pytest.mark.parametrize("reg_grads", [False, True])
@pytest.mark.parametrize("step", [0, 1])
def test_fused_step_matches_jax(jax_steps, step, reg_grads):
    cfg = Config(**CFG, sg2_reg_grads=reg_grads)
    gv, dv, reals, new, metrics, fake_j, draws = jax_steps[step,
                                                           reg_grads].result()
    G, D = build_models(cfg)
    G.load_state_dict(convert.from_jax_variables(gv, cfg, "g"), strict=True)
    D.load_state_dict(convert.from_jax_variables(dv, cfg, "d"), strict=True)
    g_opt = Adam(G.parameters(), cfg.lrG, 0.0, 0.9)
    d_opt = Adam(D.parameters(), cfg.lrD, 0.0, 0.9)
    ema = [p.detach().clone() for p in G.parameters()]
    lazy = step % LAZY_INTERVAL == 0
    replay = port_draws(draws, len(G.synthesis.noise_shapes(1)), lazy)
    got, fake, pl_mean = train_step(
        cfg, G.train(), D.train(), g_opt, d_opt, torch.from_numpy(reals),
        step, ema, torch.tensor(0.25),
        draws=Draws(torch.device("cpu"), replay=replay))

    for k in ("d_real", "d_fake", "g_loss"):
        np.testing.assert_allclose(float(got[k]), metrics[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(pl_mean), float(new.pl_mean),
                               rtol=1e-4)
    assert (float(pl_mean) != 0.25) == lazy
    scale = np.abs(fake_j).max()
    np.testing.assert_allclose(np.moveaxis(fake.numpy(), 1, -1) / scale,
                               fake_j / scale, atol=1e-4, rtol=1e-3)

    moving = {"moving": new.g_state["moving"]}
    ema_want = convert.from_jax_variables({"params": new.ema_params,
                                           **moving}, cfg, "g")
    for (name, p), e in zip(G.named_parameters(), ema):
        assert torch.equal(p, e), name
    n_checked = 0
    for which, net, opt, params, jopt, extra in (
            ("g", G, g_opt, new.g_params, new.g_opt, moving),
            ("d", D, d_opt, new.d_params, new.d_opt, {})):
        want = convert.from_jax_variables({"params": params, **extra}, cfg,
                                          which)
        nu = convert.from_jax_variables({"params": jopt[0].nu, **extra},
                                        cfg, which)
        weight = 1.0 - 0.9 ** int(jopt[0].count)
        for name, nu_t in zip([n for n, _ in net.named_parameters()],
                              opt.nu):
            g_j = np.sqrt(nu[name].numpy() / weight)
            g_t = np.sqrt(nu_t.numpy() / weight)
            np.testing.assert_allclose(g_t, g_j, rtol=0,
                                       atol=GRAD_TOL * g_j.max(),
                                       err_msg=f"{which} |grad| {name}")
            mask = g_j > max(1e-6, GRAD_TOL * g_j.max())
            np.testing.assert_allclose(
                net.state_dict()[name].numpy()[mask],
                want[name].numpy()[mask], rtol=1e-4, atol=1e-7,
                err_msg=f"{which} {name}")
            if which == "g":
                np.testing.assert_allclose(
                    net.state_dict()[name].numpy()[mask],
                    ema_want[name].numpy()[mask], rtol=1e-4, atol=1e-7,
                    err_msg=f"ema {name}")
            n_checked += int(mask.sum())
    assert n_checked > 0


def _dataset(tmp_path, n=8, r=16):
    path = os.path.join(tmp_path, "train.npz")
    rng = np.random.default_rng(0)
    np.savez(path, X=np.tanh(rng.normal(size=(n, r, r, r))).astype(np.float32))
    return path


def test_cli_train_and_resume_on_cpu(tmp_path, capsys):
    """--stylegan2=True at 16^3, filters 16: 2 steps (step 0 lazy), then a
    resume to 3; the checkpoint carries pl_mean, and the global RNG is
    untouched (every draw comes from the trainer's generators)."""
    from gan3d_tpu_torch.cli.train import main

    log_dir = str(tmp_path / "run")
    argv = [f"--data_path={_dataset(tmp_path)}", f"--log_dir={log_dir}",
            "--platform=cpu", "--stylegan2=True", "--resolution=16",
            "--filterG=16", "--filterD=16", "--z_size=8", "--batch_size=4",
            "--steps_per_log=1", "--data_loader_workers=1"]
    state = torch.random.get_rng_state()
    main(argv + ["--niters=2"])
    out = capsys.readouterr().out
    assert "[1|2]\tD(x): " in out and "...Done (2 steps in " in out
    assert os.path.isfile(os.path.join(log_dir, "images", "1.png"))
    ckpt = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                      weights_only=True)
    assert ckpt["step"] == 2 and float(ckpt["pl_mean"]) != 0.0
    assert "synthesis.b16.conv1.noise_const" in ckpt["modelG_state_dict"]
    assert "b4.fc.weight" in ckpt["modelD_state_dict"]
    with open(os.path.join(log_dir, "params.json")) as f:
        assert json.load(f)["stylegan2"] is True
    main(argv + ["--niters=3"])
    out = capsys.readouterr().out
    assert "starting from step 2" in out and "[2|3]" in out
    resumed = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                         weights_only=True)
    assert resumed["step"] == 3 and all(np.isfinite(resumed["lossG"]))
    # step 2 is not lazy: pl_mean carries over unchanged
    assert float(resumed["pl_mean"]) == float(ckpt["pl_mean"])
    assert torch.equal(torch.random.get_rng_state(), state)

"""The port's StyleGAN-1 (models/stylegan/stylegan1.py, its step and
trainer) against the JAX package's (gan3d_tpu/models/stylegan/stylegan1.py,
models/stylegan/loss.py's v1 branch).

- ``ada_in`` on random content, on the const ones block (zero variance:
  the output is the style's mean half) and in bf16 (1e-6 relative in f32;
  bf16 one rounding apart);
- ``upsample_trilinear3d`` at 2^3-5^3 (cubic and not) against the JAX op
  with ``fast_tri`` off (jax.image.resize) and on (band matmuls), f32;
- the G at 16^3, z 16 (channels 512/256/128) from the same weights, with
  the mixing draws replayed: the swap point forced to each of 0-5 (5 never
  mixes at 16^3, whose sites are 0-2) and the JAX permutation carried
  across (1e-5 of the largest value, f32);
- ``from_jax_variables`` key for key against ``export_stylegan1_g``, and a
  ``strict=True`` load;
- one fused step (iterD 2 with R1 on each D update, then the G update) at
  8^3 from the same weights, reals and draws, ``sg2_reg_grads`` False and
  True: the losses, the gradients' magnitudes and the state after the
  update (``test_torch_stylegan2_step``'s tolerances); no EMA, pl_mean
  unchanged;
- the G's forward and gradients on the ``wide_conv`` / ``fast_dw`` routes
  (their plain versions on the CPU) equal to the default route's;
- the train CLI with ``--stylegan=True`` at 16^3 for 2 steps and a resume
  to 3, pl_mean 0 in the checkpoint.
"""

import importlib
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
from gan3d_tpu.eval.export import export_stylegan1_g
from gan3d_tpu.models import build_models as jbuild
from gan3d_tpu.models.stylegan import stylegan1 as J1
from gan3d_tpu.models.stylegan.loss import build_stylegan_step
from gan3d_tpu.train.state import TrainState, make_optimizer
from gan3d_tpu_torch import convert
from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models import build_models
from gan3d_tpu_torch.models.stylegan import stylegan1 as T1
from gan3d_tpu_torch.models.stylegan.loss import Draws, train_step
from gan3d_tpu_torch.ops import conv3d as tconv
from gan3d_tpu_torch.train.state import Adam

from test_torch_step import GRAD_TOL  # noqa: E402
from test_torch_stylegan2 import (captured_draws, ncdhw,  # noqa: E402
                                  sg2_variables)

torch.set_num_threads(1)

# the module (gan3d_tpu.ops re-exports a function of the same name)
jconv = importlib.import_module("gan3d_tpu.ops.conv3d")
_TRACING = threading.Lock()
G_CFG = dict(stylegan=True, resolution=16, z_size=16, filterG=16,
             filterD=16, batch_size=4, compute_dtype="float32")
STEP_CFG = dict(stylegan=True, resolution=8, z_size=8, filterG=16,
                filterD=16, batch_size=4, iterD=2, compute_dtype="float32")


def sg1_variables(shapes, rng):
    """A random tree of the JAX StyleGAN-1 G's params at its init's scale:
    kernels N(0, 1 / fan_in), biases N(0, 0.1)."""
    def fill(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        x = rng.normal(size=leaf.shape)
        if names[-1] == "kernel":
            return (x / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return (x * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_variables(jcfg, seed=0):
    """(G, its variables, D, its variables) of the JAX package."""
    G, D = jbuild(jcfg)
    r, b = jcfg.resolution, jcfg.batch_size
    rngs = {"params": jax.random.key(0), "mixing": jax.random.key(1)}
    rng = np.random.default_rng(seed)
    gv = sg1_variables(jax.eval_shape(G.init, rngs,
                                      jnp.zeros((b, jcfg.z_size))), rng)
    dv = sg2_variables(jax.eval_shape(D.init, rngs,
                                      jnp.zeros((b, r, r, r, 1))), rng)
    return G, gv, D, dv


def port_models(cfg, gv, dv):
    G, D = build_models(cfg)
    G.load_state_dict(convert.from_jax_variables(gv, cfg, "g"), strict=True)
    D.load_state_dict(convert.from_jax_variables(dv, cfg, "d"), strict=True)
    return G, D


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["random", "const_ones", "bf16"])
def test_ada_in_matches_jax(case):
    rng = np.random.default_rng(0)
    n, c, s = 3, 5, (4, 3, 6)
    x = rng.normal(size=(n, c, *s)).astype(np.float32) * 2 + 0.5
    if case == "const_ones":
        x = np.ones_like(x)
    style = rng.normal(size=(n, 2 * c)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if case == "bf16"
                else (jnp.float32, torch.float32))
    want = np.asarray(J1.ada_in(jnp.asarray(np.moveaxis(x, 1, -1), jdt),
                                jnp.asarray(style)).astype(jnp.float32))
    got = T1.ada_in(torch.from_numpy(x).to(tdt), torch.from_numpy(style))
    assert got.dtype == tdt
    got = np.moveaxis(got.float().numpy(), 1, -1)
    if case == "bf16":
        # both in f32 from the same bf16 input, rounded once to bf16
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if case == "const_ones":
        # zero variance: the normalized content is 0, the output the mean
        np.testing.assert_array_equal(
            got, np.broadcast_to(style[:, None, None, None, :c], got.shape))


@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 3, 3), (4, 4, 4),
                                   (5, 5, 5), (2, 3, 5)])
@pytest.mark.parametrize("fast_tri", ["off", "on"])
def test_upsample_trilinear_matches_jax(shape, fast_tri):
    x = np.random.default_rng(1).normal(size=(2, 3, *shape)).astype(
        np.float32)
    try:
        jconv.set_fast_tri_mode(fast_tri)
        want = np.asarray(jconv.upsample_trilinear3d(
            jnp.asarray(np.moveaxis(x, 1, -1)), 2))
    finally:
        jconv.set_fast_tri_mode("auto")
    got = tconv.upsample_trilinear3d(torch.from_numpy(x), 2).numpy()
    assert got.shape == (2, 3, *(2 * v for v in shape))
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), want, rtol=1e-6,
                               atol=1e-6)


def test_stage_channels_match_jax():
    for r in (8, 16, 32, 64, 128, 256):
        assert T1.stage_channels(r) == J1._stage_channels(r)
    assert T1.stage_channels(64) == [512, 256, 128, 64, 32]


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def g16():
    jcfg = JConfig(**G_CFG)
    G_j, gv, _, _ = jax_variables(jcfg)
    z = np.random.default_rng(3).normal(size=(4, 16)).astype(np.float32)
    return jcfg, G_j, gv, z


@pytest.mark.parametrize("swap_point", range(6))
def test_generator_matches_jax(g16, swap_point):
    """The JAX G runs eagerly with ``jax.random.randint`` forced to the
    swap point; its permutation is recorded and replayed into the port."""
    jcfg, G_j, gv, z = g16
    saved = jax.random.randint
    jax.random.randint = lambda *a, **kw: jnp.int32(swap_point)
    try:
        with captured_draws(("permutation",)) as perms:
            want = np.asarray(G_j.apply(gv, jnp.asarray(z), train=True,
                                        rngs={"mixing": jax.random.key(7)}))
    finally:
        jax.random.randint = saved
    (perm,) = perms
    G = build_models(Config(**G_CFG))[0]
    G.load_state_dict(convert.from_jax_variables(gv, Config(**G_CFG), "g"),
                      strict=True)
    assert G.n_mix_sites == 3
    replay = [torch.tensor(swap_point), torch.from_numpy(np.array(perm))]
    with torch.no_grad():
        got = G.train()(torch.from_numpy(z),
                        draws=Draws(torch.device("cpu"), replay=replay))
    got = np.moveaxis(got.numpy(), 1, -1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-5)
    if swap_point < 3:
        # the mixing is live: the image differs from the unmixed one
        with torch.no_grad():
            plain = G.eval()(torch.from_numpy(z)).numpy()
        assert np.abs(np.moveaxis(plain, 1, -1) - want).max() > 1e-4


def test_convert_matches_export_key_for_key(g16):
    jcfg, _, gv, _ = g16
    cfg = Config(**G_CFG)
    sd = convert.from_jax_variables(gv, cfg, "g")
    ref = export_stylegan1_g(jax.tree.map(np.asarray, gv), jcfg)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    G = build_models(cfg)[0]
    assert sorted(G.state_dict()) == sorted(sd)
    G.load_state_dict(sd, strict=True)


def test_knob_routes_match_default_route_on_cpu():
    """wide_conv / fast_dw on: the G's eligible convs take the kernels'
    autograd routes (their plain versions here); forward and gradients
    equal the default F.conv3d route's."""
    cfg = Config(**dict(G_CFG, batch_size=2))
    G = build_models(cfg)[0].eval()
    z = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 16)).astype(np.float32))
    outs = {}
    try:
        for mode in ("off", "on"):
            tconv.set_wide_conv_mode(mode)
            tconv.set_fast_dw_mode(mode)
            G.zero_grad()
            y = G(z)
            (y.float() ** 2).sum().backward()
            outs[mode] = (y.detach(), {n: p.grad.clone()
                                      for n, p in G.named_parameters()})
    finally:
        tconv.set_wide_conv_mode("auto")
        tconv.set_fast_dw_mode("auto")
    (y0, g0), (y1, g1) = outs["off"], outs["on"]
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=0,
                               atol=1e-5 * y0.abs().max().item())
    for n, g in g0.items():
        np.testing.assert_allclose(g1[n].numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * g.abs().max().item(),
                                   err_msg=n)


# ---------------------------------------------------------------------------
# the fused step
# ---------------------------------------------------------------------------
def jax_sg1_step(cfg_kw, seed=0):
    """One JAX StyleGAN-1 step (R1 on, PL off: the trainer's one program)
    from random weights; returns (gv, dv, reals, the new state, metrics,
    the G update's image, the draws in call order)."""
    jcfg = JConfig(**cfg_kw)
    R, B = jcfg.resolution, jcfg.batch_size
    G_j, gv, D_j, dv = jax_variables(jcfg, seed)
    rng = np.random.default_rng(seed + 1)
    reals = np.tanh(rng.normal(size=(jcfg.iterD, B, 1, R, R, R))
                    ).astype(np.float32)
    g_tx = make_optimizer(jcfg.lrG, 0.0, 0.9)
    d_tx = make_optimizer(jcfg.lrD, 0.0, 0.9)
    state = TrainState(
        step=jnp.int32(0), g_params=gv["params"], g_state={},
        g_opt=g_tx.init(gv["params"]), d_params=dv["params"], d_state={},
        d_opt=d_tx.init(dv["params"]), ema_params=None,
        pl_mean=jnp.float32(0))
    fn = build_stylegan_step(jcfg, G_j, D_j, g_tx, d_tx, static_r1=True,
                             static_pl=False)

    def run(state, reals, key):
        with captured_draws(("normal", "randint", "permutation")) as draws:
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


@pytest.fixture(scope="module")
def jax_steps():
    with ThreadPoolExecutor(max_workers=2) as pool:
        yield {reg: pool.submit(jax_sg1_step, dict(STEP_CFG,
                                                   sg2_reg_grads=reg))
               for reg in (False, True)}


@pytest.mark.parametrize("reg_grads", [False, True])
def test_fused_step_matches_jax(jax_steps, reg_grads):
    cfg = Config(**STEP_CFG, sg2_reg_grads=reg_grads)
    gv, dv, reals, new, metrics, fake_j, draws = jax_steps[reg_grads].result()
    # each update: z, the swap point, the permutation
    assert [d.shape for d in draws] == [(4, 8), (), (4,)] * 3
    G, D = port_models(cfg, gv, dv)
    g_opt = Adam(G.parameters(), cfg.lrG, 0.0, 0.9)
    d_opt = Adam(D.parameters(), cfg.lrD, 0.0, 0.9)
    replay = [torch.from_numpy(np.array(ncdhw(d) if d.ndim == 5 else d))
              for d in draws]
    got, fake, pl_mean = train_step(
        cfg, G.train(), D.train(), g_opt, d_opt, torch.from_numpy(reals),
        0, [], torch.tensor(0.0),
        draws=Draws(torch.device("cpu"), replay=replay))

    for k in ("d_real", "d_fake", "g_loss"):
        np.testing.assert_allclose(float(got[k]), metrics[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(pl_mean) == 0.0 == float(new.pl_mean)
    scale = np.abs(fake_j).max()
    np.testing.assert_allclose(np.moveaxis(fake.numpy(), 1, -1) / scale,
                               fake_j / scale, atol=1e-4, rtol=1e-3)
    n_checked = 0
    for which, net, opt, params, jopt in (
            ("g", G, g_opt, new.g_params, new.g_opt),
            ("d", D, d_opt, new.d_params, new.d_opt)):
        want = convert.from_jax_variables({"params": params}, cfg, which)
        nu = convert.from_jax_variables({"params": jopt[0].nu}, cfg, which)
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
            n_checked += int(mask.sum())
    assert n_checked > 0


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def test_cli_train_and_resume_on_cpu(tmp_path, capsys):
    """--stylegan=True at 16^3: 2 steps, then a resume to 3; the
    checkpoint holds pl_mean 0 and the reference's key names, and the
    global RNG is untouched."""
    from gan3d_tpu_torch.cli.train import main

    path = os.path.join(tmp_path, "train.npz")
    rng = np.random.default_rng(0)
    np.savez(path, X=np.tanh(rng.normal(size=(8, 16, 16, 16))).astype(
        np.float32))
    log_dir = str(tmp_path / "run")
    argv = [f"--data_path={path}", f"--log_dir={log_dir}", "--platform=cpu",
            "--stylegan=True", "--resolution=16", "--filterG=16",
            "--filterD=16", "--z_size=8", "--batch_size=4",
            "--steps_per_log=1", "--data_loader_workers=1"]
    state = torch.random.get_rng_state()
    main(argv + ["--niters=2"])
    out = capsys.readouterr().out
    assert "[1|2]\tD(x): " in out and "...Done (2 steps in " in out
    assert os.path.isfile(os.path.join(log_dir, "images", "1.png"))
    ckpt = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                      weights_only=True)
    assert ckpt["step"] == 2 and float(ckpt["pl_mean"]) == 0.0
    assert "latentMapping.14.weight" in ckpt["modelG_state_dict"]
    assert "C4.0.weight" in ckpt["modelG_state_dict"]
    assert "b4.fc.weight" in ckpt["modelD_state_dict"]
    with open(os.path.join(log_dir, "params.json")) as f:
        assert json.load(f)["stylegan"] is True
    main(argv + ["--niters=3"])
    out = capsys.readouterr().out
    assert "starting from step 2" in out and "[2|3]" in out
    resumed = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                         weights_only=True)
    assert resumed["step"] == 3 and all(np.isfinite(resumed["lossG"]))
    assert float(resumed["pl_mean"]) == 0.0
    assert torch.equal(torch.random.get_rng_state(), state)

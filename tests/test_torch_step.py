"""One fused train step of the port against gan3d_tpu.train.step.

The JAX step (``build_train_step``: iterD=2 D-updates, then one G-update,
hinge loss, Adam b1=0) and the port's ``train_step`` start from the same
weights (carried across with gan3d_tpu_torch.convert), see the same reals
and the same noise: the test derives the JAX step's noise from its keys
(``fold_step`` and the splits at gan3d_tpu/train/step.py:57-58, 98-99 and
132-137) and injects it into the port's step. Compared afterwards:

- the losses (rtol 1e-4);
- the gradients' magnitudes, read from Adam's second moment nu as
  sqrt(nu / (1 - b2^t)), to within 5e-3 of the tensor's largest value (the
  G attention's key and value gradients sum 32768 query terms through the
  softmax's cancellation; everything else agrees to ~1e-4); a conv bias
  that feeds a BN has a gradient that is zero up to rounding (below 1e-4
  in JAX, against >= 2e-3 for every other tensor here) and must be below
  1e-4 in the port too;
- every parameter, where that gradient is above 1e-6 and above the
  gradient tolerance: with b1=0 one update is ~lr*sign(g), so an entry
  whose gradient is within the frameworks' rounding differences can take
  the other sign (rtol 1e-4 / atol 1e-7);
- every BN running stat and SN vector of G and D (atol 1e-5 / rtol 1e-4).

Config: resolution 32, filters 8, batch 2, sagan (one deep block per
stage, attention at 32^3 in G and 16^3 in D), f32.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from gan3d_tpu.config import Config as JConfig
from gan3d_tpu.models import build_models as jbuild
from gan3d_tpu.train.state import TrainState, make_optimizer
from gan3d_tpu.train.step import build_train_step
from gan3d_tpu.utils.prng import fold_step
from gan3d_tpu_torch import convert
from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models import build_models
from gan3d_tpu_torch.train.state import Adam
from gan3d_tpu_torch.train.step import train_step

from test_torch_layers import jax_reference_lowering  # noqa: F401,E402

torch.set_num_threads(1)

CFG = dict(resolution=32, filterG=8, filterD=8, z_size=16, batch_size=2,
           iterD=2, sagan=True, hinge=True, compute_dtype="float32")
STATE_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = 5e-3


def to_np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def random_variables(shapes, rng):
    def fill(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if names[0] == "spectral":
            u = rng.normal(size=leaf.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        if names[-1] == "gamma":
            return np.float32(0.5)
        x = rng.normal(size=leaf.shape) * 0.1
        if names[-1] in ("var", "scale"):
            x = 1.0 + np.abs(x) if names[-1] == "var" else 1.0 + x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_noise(cfg, base_key, step=0):
    """The noise build_train_step draws at ``step`` (step.py:57-58, 98-99,
    132-137)."""
    key = fold_step(base_key, step)
    out = []
    for i in range(cfg.iterD):
        kz = jax.random.split(jax.random.fold_in(key, i), 4)[0]
        out.append(jax.random.normal(kz, (cfg.batch_size, cfg.z_size)))
    kz = jax.random.split(jax.random.fold_in(key, 1000))[0]
    out.append(jax.random.normal(kz, (cfg.batch_size, cfg.z_size)))
    return [np.array(n) for n in out]


def test_fused_step_matches_jax():
    jcfg, cfg = JConfig(**CFG), Config(**CFG)
    R = cfg.resolution
    G_j, D_j = jbuild(jcfg)
    rng = np.random.default_rng(0)
    gv = random_variables(jax.eval_shape(
        G_j.init, {"params": jax.random.key(0)}, jnp.zeros((2, 16))), rng)
    dv = random_variables(jax.eval_shape(
        D_j.init, {"params": jax.random.key(0)},
        jnp.zeros((2, R, R, R, 1))), rng)
    reals = np.tanh(rng.normal(size=(2, 2, 1, R, R, R))).astype(np.float32)

    # --- JAX ---
    g_tx = make_optimizer(cfg.lrG, 0.0, 0.9)
    d_tx = make_optimizer(cfg.lrD, 0.0, 0.9)
    split = lambda v: (v["params"], {k: x for k, x in v.items()  # noqa: E731
                                     if k != "params"})
    gp, gs = split(gv)
    dp, ds = split(dv)
    state = TrainState(step=jnp.int32(0), g_params=gp, g_state=gs,
                       g_opt=g_tx.init(gp), d_params=dp, d_state=ds,
                       d_opt=d_tx.init(dp))
    base_key = jax.random.key(5)
    step = jax.jit(build_train_step(jcfg, G_j, D_j, g_tx, d_tx))
    new, metrics, _ = step(state, jnp.asarray(np.moveaxis(reals, 2, -1)),
                           base_key)
    new = to_np(new)

    # --- port ---
    G, D = build_models(cfg)
    G.load_state_dict(convert.from_jax_variables(gv, cfg, "g"), strict=True)
    D.load_state_dict(convert.from_jax_variables(dv, cfg, "d"), strict=True)
    g_opt = Adam(G.parameters(), cfg.lrG, 0.0, 0.9)
    d_opt = Adam(D.parameters(), cfg.lrD, 0.0, 0.9)
    noises = [torch.from_numpy(n) for n in jax_noise(cfg, base_key)]
    got, fake = train_step(cfg, G.train(), D.train(), g_opt, d_opt,
                           torch.from_numpy(reals), noises=noises)
    assert fake.shape == (2, 1, R, R, R)

    # losses
    for k in ("d_real", "d_fake", "g_loss"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)

    for which, net, opt, params, st, jopt in (
            ("g", G, g_opt, new.g_params, new.g_state, new.g_opt),
            ("d", D, d_opt, new.d_params, new.d_state, new.d_opt)):
        want = convert.from_jax_variables({"params": params, **st}, cfg,
                                          which)
        nu = convert.from_jax_variables({"params": jopt[0].nu, **st}, cfg,
                                        which)
        # Adam's bias-corrected nu weight: sum_t (1-b2) b2^(T-t) = 1 - b2^T
        weight = 1.0 - 0.9 ** int(jopt[0].count)
        sd = net.state_dict()
        names = [n for n, _ in net.named_parameters()]
        assert len(names) == len(opt.nu)
        for name, nu_t in zip(names, opt.nu):
            g_j = np.sqrt(nu[name].numpy() / weight)
            g_t = np.sqrt(nu_t.numpy() / weight)
            if g_j.max() <= 1e-4:
                # zero up to rounding: a conv bias that feeds a BN
                assert g_t.max() <= 1e-4, (which, name, g_t.max())
                continue
            np.testing.assert_allclose(g_t, g_j, rtol=0,
                                       atol=GRAD_TOL * g_j.max(),
                                       err_msg=f"{which} |grad| {name}")
            mask = g_j > max(1e-6, GRAD_TOL * g_j.max())
            np.testing.assert_allclose(sd[name].numpy()[mask],
                                       want[name].numpy()[mask], rtol=1e-4,
                                       atol=1e-7, err_msg=f"{which} {name}")
        n_state = 0
        for key, value in want.items():
            if key.endswith(("running_mean", "running_var", "._u", "._v")):
                np.testing.assert_allclose(sd[key].numpy(), value.numpy(),
                                           **STATE_TOL,
                                           err_msg=f"{which} {key}")
                n_state += 1
        assert n_state > 0


@pytest.mark.parametrize("b1,mu_free", [(0.0, True), (0.0, False),
                                        (0.5, True)])
def test_adam_matches_optax(b1, mu_free):
    """The port's Adam against the JAX package's make_optimizer (its
    mu-free b1=0 form, and optax.adam otherwise) over three steps; rtol
    1e-6 (the same f32 operations in the same order)."""
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=(5, 4)).astype(np.float32) for _ in range(3)]
    tx = make_optimizer(1e-3, b1, 0.9, mu_free=mu_free)
    pj = jnp.asarray(p0)
    sj = tx.init(pj)
    pt = torch.from_numpy(p0.copy())
    opt = Adam([pt], 1e-3, b1, 0.9, mu_free=mu_free)
    assert (opt.mu is None) == (b1 == 0.0 and mu_free)
    for g in grads:
        upd, sj = tx.update(jnp.asarray(g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        opt.step([torch.from_numpy(g)])
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6,
                                   atol=1e-7)


def test_wgan_gp_step_on_cpu():
    """The WGAN loss with the gradient penalty (a double backward through
    D) runs on the CPU's plain path: finite losses, every D parameter
    updated but the output bias (whose WGAN gradient, mean over fakes minus
    mean over reals, is exactly 0). The penalty's interpolation draws come
    from each framework's own generator, so there is no JAX comparison
    here."""
    cfg = Config(resolution=16, filterG=8, filterD=8, z_size=8, batch_size=2,
                 iterD=2, biggan=True, hinge=False, gp_weight=10.0,
                 compute_dtype="float32")
    G, D = build_models(cfg)
    before = [p.detach().clone() for p in D.parameters()]
    g_opt = Adam(G.parameters(), cfg.lrG, 0.0, 0.9)
    d_opt = Adam(D.parameters(), cfg.lrD, 0.0, 0.9)
    reals = torch.tanh(torch.randn((2, 2, 1, 16, 16, 16),
                                   generator=torch.Generator().manual_seed(0)))
    metrics, _ = train_step(cfg, G.train(), D.train(), g_opt, d_opt, reals,
                            generator=torch.Generator().manual_seed(1))
    assert all(torch.isfinite(v) for v in metrics.values())
    changed = {name for (name, p), b in zip(D.named_parameters(), before)
               if not torch.equal(p, b)}
    assert {n for n, _ in D.named_parameters()} - changed == {"linear.bias"}

"""The port's DCGAN-3D family and the hybrid against the JAX package's.

- ConvTranspose3d (the JAX kernel through ``convert.conv_state(...,
  transposed=True)``: no flip) and LayerNormVolume (f32 and bf16 inputs)
  against their JAX modules.
- ``convert.from_jax_variables`` equals ``gan3d_tpu.eval.export``'s
  ``export_dcgan_g/d`` (and ``export_biggan_g`` for the hybrid's G) key for
  key and value for value, and loads into the port's modules with
  strict=True: G plain and sagan, the four D variants, the hybrid pair.
- One train-mode forward of G (plain, sagan) and of D (WGAN-LN, msl,
  sngan, sagan) at 32^3, and of the hybrid pair (BigGAN G into the DCGAN
  sagan D) at 16^3, filters 8, batch 2, f32: the output and every BN/SN
  leaf afterwards.
  The msl D's crop offsets are read off the JAX module's captured
  RandomCrop3D output (each input sample is a random permutation of
  distinct values, so each crop's first voxel names its corner; the whole
  crop is then checked) and fed to the port through ``offsets``.
- One fused train step at 16^3 against the JAX step (``test_torch_step``'s
  harness and tolerances): losses, gradients, the parameters after the
  update and the BN/SN state, for the WGAN-LN DCGAN (its D has no state)
  and for the SN D with the gradient penalty.
- RandomCrop3D's gather against slices at its offsets, and the msl step's
  draws (one a D forward; the penalty's forward reuses D(real)'s).

Tolerances (``test_torch_biggan``'s): outputs atol 1e-4 / rtol 1e-3 scaled
to unit maximum, state leaves atol 1e-5 / rtol 1e-4 (f32, different
summation orders). The JAX variables are random trees of the JAX modules'
own structure (``jax.eval_shape`` of their init), filled from a numpy seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan3d_tpu.config import Config as JConfig
from gan3d_tpu.eval.export import (export_biggan_g, export_dcgan_d,
                                   export_dcgan_g)
from gan3d_tpu.models import build_models as jbuild
from gan3d_tpu.nn.layers import ConvTranspose3d as JConvTranspose3d
from gan3d_tpu.nn.msl import RandomCrop3D as JRandomCrop3D
from gan3d_tpu.nn.norm import LayerNormVolume as JLayerNormVolume
from gan3d_tpu_torch import convert
from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models import build_models
from gan3d_tpu_torch.nn import ConvTranspose3d, LayerNormVolume

from test_torch_layers import jax_reference_lowering  # noqa: F401,E402
from test_torch_step import (jax_step, port_step_matches,  # noqa: E402
                             random_variables, to_np)

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
OUT_TOL = dict(atol=1e-4, rtol=1e-3)
R = 32
VARIANTS = {
    "wgan": dict(dcgan=True),
    "msl": dict(dcgan=True, msl=True),
    "sngan": dict(dcgan=True, sngan=True),
    "sagan": dict(dcgan=True, sagan=True),
    "hybrid": dict(hybrid=True, sagan=True),
}


def configs(**kw):
    base = dict(resolution=R, filterG=8, filterD=8, z_size=8, batch_size=2,
                compute_dtype="float32")
    base.update(kw)
    return JConfig(**base), Config(**base)


def ndhwc(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def jax_variables(jcfg, which, seed=0):
    G, D = jbuild(jcfg)
    mod = G if which == "g" else D
    x = (jnp.zeros((2, jcfg.z_size)) if which == "g" else
         jnp.zeros((2, jcfg.resolution, jcfg.resolution, jcfg.resolution,
                    1)))
    rngs = {"params": jax.random.key(0), "crops": jax.random.key(1)}
    shapes = jax.eval_shape(mod.init, rngs, x)
    return mod, random_variables(shapes, np.random.default_rng(seed))


def port_module(cfg, which, variables):
    G, D = build_models(cfg)
    mod = G if which == "g" else D
    mod.load_state_dict(convert.from_jax_variables(variables, cfg, which),
                        strict=True)
    return mod.train()


def check_state(module, cfg, which, variables, new_state):
    want = convert.from_jax_variables(
        {"params": variables["params"], **new_state}, cfg, which)
    got = module.state_dict()
    n = 0
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var", "._u", "._v")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       **TOL, err_msg=key)
            n += 1
    return n


def assert_scaled_close(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, **OUT_TOL)


@pytest.mark.parametrize("k,s,p,side", [(4, 1, 0, 1), (4, 2, 1, 5)])
def test_conv_transpose3d_matches_jax(k, s, p, side):
    rng = np.random.default_rng(k * 10 + side)
    x = rng.normal(size=(2, 6, side, side, side)).astype(np.float32)
    jmod = JConvTranspose3d(5, kernel_size=k, stride=s, padding=p)
    jv = to_np(jmod.init(jax.random.key(0), jnp.asarray(ndhwc(x))))
    jv["params"]["bias"] = rng.normal(size=5).astype(np.float32)
    sd = {}
    convert.conv_state(sd, "", jv["params"], None, transposed=True)
    tmod = ConvTranspose3d(6, 5, k, s, p)
    tmod.load_state_dict(sd, strict=True)
    y_j = np.asarray(jmod.apply(jv, jnp.asarray(ndhwc(x))))
    y_t = tmod(torch.from_numpy(x)).detach().numpy()
    assert y_t.shape[2] == (side - 1) * s - 2 * p + k
    np.testing.assert_allclose(ndhwc(y_t), y_j, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_volume_matches_jax(dtype):
    """Per-sample statistics over (C, D, H, W) in f32, a full-shape affine,
    the output in the input's dtype (bf16: one rounding, 2^-8)."""
    rng = np.random.default_rng(3)
    shape = (4, 3, 5, 6)                                   # (D, H, W, C)
    x = (rng.normal(size=(2, 6, 4, 3, 5)) * 3 + 1).astype(np.float32)
    jmod = JLayerNormVolume(shape)
    params = {"scale": rng.normal(size=shape).astype(np.float32),
              "bias": rng.normal(size=shape).astype(np.float32)}
    sd = {}
    convert.layernorm_state(sd, "", params)
    tmod = LayerNormVolume((6, 4, 3, 5))
    tmod.load_state_dict(sd, strict=True)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    y_j = jmod.apply({"params": params}, jnp.asarray(ndhwc(x), jdt))
    y_t = tmod(torch.from_numpy(x).to(tdt))
    assert y_t.dtype == tdt
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(ndhwc(y_t.float().detach().numpy()),
                               np.asarray(y_j.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("which,variant", [
    ("g", "wgan"), ("g", "sagan"), ("d", "wgan"), ("d", "msl"),
    ("d", "sngan"), ("d", "sagan"), ("g", "hybrid"), ("d", "hybrid")])
def test_convert_equals_export(which, variant):
    jcfg, cfg = configs(**VARIANTS[variant])
    _, variables = jax_variables(jcfg, which)
    export = (export_dcgan_d if which == "d" else
              export_biggan_g if variant == "hybrid" else export_dcgan_g)
    want = export(variables, jcfg)
    got = convert.from_jax_variables(variables, cfg, which)
    assert list(got) == list(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    G, D = build_models(cfg)
    (G if which == "g" else D).load_state_dict(got, strict=True)


@pytest.mark.parametrize("variant", ["wgan", "sagan"])
def test_generator_forward_and_state(variant):
    jcfg, cfg = configs(**VARIANTS[variant])
    G_j, variables = jax_variables(jcfg, "g", seed=1)
    G = port_module(cfg, "g", variables)
    z = np.random.default_rng(2).normal(size=(2, 8)).astype(np.float32)
    state = [k for k in variables if k != "params"]
    y_j, new_state = jax.jit(lambda v, z: G_j.apply(
        v, z, train=True, mutable=state))(variables, jnp.asarray(z))
    y_t = G(torch.from_numpy(z)).detach().numpy()
    assert y_t.shape == (2, 1, R, R, R)
    assert_scaled_close(ndhwc(y_t), np.asarray(y_j))
    n = check_state(G, cfg, "g", variables, to_np(new_state))
    assert n == 6 + (8 if variant == "sagan" else 0)


def jax_crop_offsets(crops, vol):
    """The corner of each captured crop ([N, r, r, r, K]) in ``vol``
    ([N, R, R, R]; each sample's values distinct), found from its first
    voxel and then checked on the whole crop: [N, K, 3]."""
    n, r, k = crops.shape[0], crops.shape[1], crops.shape[-1]
    off = np.zeros((n, k, 3), np.int64)
    for i in range(n):
        where = {v: idx for idx, v in np.ndenumerate(vol[i])}
        assert len(where) == vol[i].size
        for j in range(k):
            c = where[crops[i, 0, 0, 0, j]]
            np.testing.assert_array_equal(
                crops[i, ..., j],
                vol[i, c[0]:c[0] + r, c[1]:c[1] + r, c[2]:c[2] + r])
            off[i, j] = c
    return off


@pytest.mark.parametrize("variant", ["wgan", "msl", "sngan", "sagan"])
def test_discriminator_forward_and_state(variant):
    jcfg, cfg = configs(**VARIANTS[variant])
    D_j, variables = jax_variables(jcfg, "d", seed=3)
    D = port_module(cfg, "d", variables)
    # each sample a random permutation of distinct values in [-1, 1)
    rng = np.random.default_rng(4)
    x = np.stack([rng.permutation(R ** 3) for _ in range(2)])
    x = (x / R ** 3 * 2 - 1).astype(np.float32).reshape(2, 1, R, R, R)
    state = [k for k in variables if k != "params"]
    y_j, new_state = jax.jit(lambda v, x: D_j.apply(
        v, x, mutable=state + ["intermediates"],
        rngs={"crops": jax.random.key(7)},
        capture_intermediates=lambda mdl, _: isinstance(mdl, JRandomCrop3D))
    )(variables, jnp.asarray(ndhwc(x)))
    new_state = dict(new_state)
    inter = new_state.pop("intermediates", {})
    offsets = None
    if variant == "msl":
        crops = np.asarray(inter["RandomCrop3D_0"]["__call__"][0])
        offsets = torch.from_numpy(jax_crop_offsets(crops, x[:, 0]))
        y_t = D(torch.from_numpy(x), offsets)
    else:
        assert not inter
        y_t = D(torch.from_numpy(x))
    assert y_t.shape == (2, 1)
    assert_scaled_close(y_t.detach().numpy(), np.asarray(y_j))
    n = check_state(D, cfg, "d", variables, to_np(new_state))
    # SN (u, v) pairs: msl 3 convs, sngan 4, sagan 4 + the attention's 4
    assert n == {"wgan": 0, "msl": 6, "sngan": 8, "sagan": 16}[variant]


def test_hybrid_pair_forward():
    """The hybrid's BigGAN G into its DCGAN D (sagan: SN convs, attention
    at 8^3), at 16^3: G's output and state, D's output on G's output and
    D's state."""
    jcfg, cfg = configs(resolution=16, **VARIANTS["hybrid"])
    G_j, gv = jax_variables(jcfg, "g", seed=5)
    D_j, dv = jax_variables(jcfg, "d", seed=6)
    G, D = port_module(cfg, "g", gv), port_module(cfg, "d", dv)
    z = np.random.default_rng(7).normal(size=(2, 8)).astype(np.float32)
    def pair(gv, dv, z):
        x, g_state = G_j.apply(gv, z, train=True,
                               mutable=["batch_stats", "spectral"])
        return (x, g_state, *D_j.apply(dv, x, mutable=["spectral"]))

    x_j, g_state, y_j, d_state = jax.jit(pair)(gv, dv, jnp.asarray(z))
    x_t = G(torch.from_numpy(z))
    y_t = D(x_t)
    assert x_t.shape == (2, 1, 16, 16, 16)
    assert_scaled_close(ndhwc(x_t.detach().numpy()), np.asarray(x_j))
    assert_scaled_close(y_t.detach().numpy(), np.asarray(y_j))
    assert check_state(G, cfg, "g", gv, to_np(g_state)) > 0
    assert check_state(D, cfg, "d", dv, to_np(d_state)) > 0


@pytest.mark.parametrize("variant", ["wgan", "sngan_gp"])
def test_fused_step_matches_jax(variant):
    """One fused step (iterD=2, WGAN loss, Adam b1=0) at 16^3, filters 8,
    batch 2, against the JAX step: the default DCGAN (WGAN-LN D), and the
    SN D with the gradient penalty (the JAX step's interpolation weights
    fed to the port; the penalty's D forward from the update's starting
    SN state, whose writes are discarded)."""
    kw = dict(resolution=16, filterG=8, filterD=8, z_size=8, batch_size=2,
              iterD=2, dcgan=True, hinge=False, compute_dtype="float32")
    if variant == "sngan_gp":
        kw.update(sngan=True, gp_weight=10.0)
    port_step_matches(Config(**kw), jax_step(kw),
                      stateful=("g",) if variant == "wgan" else ("g", "d"))


def test_random_crop3d_gathers_the_drawn_crops():
    """RandomCrop3D: offsets in [0, side - side/2] from the generator given
    (the same seed, the same offsets), and the one gather equals the
    slices at those offsets; offsets of the wrong shape are refused."""
    from gan3d_tpu_torch.nn import RandomCrop3D

    crop = RandomCrop3D(16)
    x = torch.randn((2, 1, 8, 6, 10), generator=torch.Generator().manual_seed(0))
    off = crop.draw_offsets(x.shape, torch.Generator().manual_seed(1))
    again = crop.draw_offsets(x.shape, torch.Generator().manual_seed(1))
    assert off.shape == (2, 16, 3) and torch.equal(off, again)
    assert (off >= 0).all() and (off <= torch.tensor([4, 3, 5])).all()
    y = crop(x, off)
    assert y.shape == (2, 16, 4, 3, 5)
    for n in range(2):
        for k in range(16):
            d, h, w = off[n, k].tolist()
            assert torch.equal(y[n, k], x[n, 0, d:d + 4, h:h + 3, w:w + 5])
    with pytest.raises(ValueError, match="offsets"):
        crop(x, off[:, :8])


def test_msl_d_needs_its_offsets():
    """The msl D takes its crop offsets from its caller and draws none of
    its own (so never from the global RNG); a D without RandomCrop3D
    refuses them."""
    cfg = Config(resolution=16, filterG=8, filterD=8, z_size=8, batch_size=2,
                 dcgan=True, msl=True, compute_dtype="float32")
    _, D = build_models(cfg)
    D.eval()                         # no power step: two calls agree
    x = torch.randn((2, 1, 16, 16, 16),
                    generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="offsets"):
        D(x)
    off = D.draw_offsets(x, torch.Generator().manual_seed(1))
    assert off.shape == (2, 128, 3)
    assert torch.equal(D(x, off), D(x, off.clone()))
    _, plain = build_models(cfg.replace(msl=False))
    with pytest.raises(ValueError, match="offsets"):
        plain(x, off)


def test_msl_step_draws_offsets_per_d_forward(monkeypatch):
    """The msl D in one fused step with the gradient penalty (iterD=2): each
    D forward crops at offsets drawn from the step's generator, D(real) and
    D(fake) at different ones, the penalty's forward at D(real)'s (as the
    JAX step's kcrop_r, gan3d_tpu/train/step.py:81); 7 forwards in all."""
    from gan3d_tpu_torch.nn.msl import RandomCrop3D
    from gan3d_tpu_torch.train.state import Adam
    from gan3d_tpu_torch.train.step import train_step

    seen = []
    forward = RandomCrop3D.forward

    def spy(self, x, offsets):
        out = forward(self, x, offsets)
        seen.append(offsets)
        return out

    monkeypatch.setattr(RandomCrop3D, "forward", spy)
    cfg = Config(resolution=16, filterG=8, filterD=8, z_size=8, batch_size=2,
                 iterD=2, dcgan=True, msl=True, gp_weight=10.0,
                 compute_dtype="float32")
    G, D = build_models(cfg)
    reals = torch.tanh(torch.randn((2, 2, 1, 16, 16, 16),
                                   generator=torch.Generator().manual_seed(0)))
    metrics, _ = train_step(cfg, G.train(), D.train(),
                            Adam(G.parameters(), 1e-4, 0.0, 0.9),
                            Adam(D.parameters(), 1e-4, 0.0, 0.9), reals,
                            generator=torch.Generator().manual_seed(1))
    assert all(torch.isfinite(v) for v in metrics.values())
    assert len(seen) == 7
    for i in (0, 3):                       # real, fake, penalty per update
        assert seen[i] is not None and seen[i + 2] is seen[i]
        assert seen[i + 1] is not None and not torch.equal(seen[i],
                                                           seen[i + 1])
    assert seen[6] is not None

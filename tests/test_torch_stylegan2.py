"""The port's StyleGAN2-3D modules against the JAX package's.

- ``setup_filter`` equals ``setup_filter_np`` (the tiled 2-D outer
  product);
- ``upfirdn3d`` (unflipped filter: no caller flips it) and every
  ``conv3d_resample`` branch (1x1 down, 1x1 up,
  down, up with either weight flip, up + down, plain symmetric, plain
  with asymmetric or negative pads), at C = 1 and C = 8, against the JAX
  functions with their ``fast_fir`` and ``fast_c1`` lowerings both off
  and on (the modes are set here and restored after each test);
- ``modulated_conv3d``, fused (one grouped conv) and not, with and
  without demodulation, noise and upsampling;
- ``FullyConnectedLayer`` (lr_mult 1 and 0.01) and the mapping network
  with truncation;
- the G forward at 16^3 (channels 4/2/1), in train mode (the modulated
  convs unfused) and eval mode (fused), with the noise the JAX G draws
  injected; the D forward at batch 8 (minibatch-std groups of 4), and the
  minibatch-std group assignment pinned to the JAX package's;
- ``from_jax_variables`` against ``export_stylegan2_g`` /
  ``export_stylegan_d`` key for key and value for value, and a strict
  ``load_state_dict``.

All in f32. Tolerances: op outputs 1e-5 of the output's largest value
(the same f32 taps summed in different orders); network outputs atol
1e-4 / rtol 1e-3 scaled to unit maximum, ``test_torch_dcgan``'s. The JAX
variables are random trees of the JAX modules' own structure
(``jax.eval_shape`` of their init), filled from a numpy seed.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan3d_tpu.config import Config as JConfig
from gan3d_tpu.eval.export import export_stylegan2_g, export_stylegan_d
from gan3d_tpu.models import build_models as jbuild
from gan3d_tpu.models.stylegan import layers as JL
from gan3d_tpu.models.stylegan import resample as JR
from gan3d_tpu.models.stylegan.discriminator import \
    MinibatchStdLayer as JMinibatchStd
from gan3d_tpu.models.stylegan.mapping import MappingNetwork as JMapping
from gan3d_tpu.ops import c1_conv
from gan3d_tpu_torch import convert
from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models import build_models
from gan3d_tpu_torch.models.stylegan import layers as TL
from gan3d_tpu_torch.models.stylegan import resample as TR
from gan3d_tpu_torch.models.stylegan.discriminator import MinibatchStdLayer
from gan3d_tpu_torch.models.stylegan.mapping import MappingNetwork

torch.set_num_threads(1)

OP_TOL = 1e-5
OUT_TOL = dict(atol=1e-4, rtol=1e-3)
RNG = np.random.default_rng(9)


def rand(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def ndhwc(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def ncdhw(x):
    return np.moveaxis(np.asarray(x), -1, 1)


def torch_w(w):
    """JAX conv weight [k, k, k, I, O] -> the port's [O, I, k, k, k]."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


def assert_op_close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= OP_TOL, err


def assert_scaled_close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, **OUT_TOL)


@pytest.fixture(params=["off", "on"])
def jax_lowering(request):
    """The JAX package's fast_fir and fast_c1 modes, both ``off`` or both
    ``on``, restored afterwards."""
    fir, c1 = JR._FIR_MODE, c1_conv._MODE
    JR.set_fast_fir_mode(request.param)
    c1_conv.set_fast_c1_mode(request.param)
    try:
        yield request.param
    finally:
        JR.set_fast_fir_mode(fir)
        c1_conv.set_fast_c1_mode(c1)


def test_setup_filter_matches_jax():
    want = JR.setup_filter_np()
    np.testing.assert_array_equal(TR.setup_filter_np(), want)
    np.testing.assert_array_equal(TR.setup_filter().numpy(), want)
    # the tiled quirk: constant along the middle axis, sum 1
    np.testing.assert_array_equal(want, np.broadcast_to(want[:, :1],
                                                        want.shape))
    assert abs(want.sum() - 1.0) < 1e-6


UPFIRDN_CASES = [  # up, down, padding (x0, x1, y0, y1, z0, z1)
    (1, 1, (1, 1, 1, 1, 1, 1)),
    (2, 1, (2, 1, 2, 1, 2, 1)),
    (1, 2, (1, 2, 0, 1, 1, 1)),
    (2, 2, (2, 2, 2, 2, 2, 2)),
    (1, 1, (-1, 2, 0, 1, 2, -1)),
]


@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("up,down,pad", UPFIRDN_CASES)
def test_upfirdn3d_matches_jax(jax_lowering, c, up, down, pad):
    x = rand(2, c, 6, 7, 8)
    want = JR.upfirdn3d(jnp.asarray(ndhwc(x)), JR.setup_filter(), up=up,
                        down=down, padding=pad, gain=3.0)
    got = TR.upfirdn3d(torch.from_numpy(x), TR.setup_filter(), up=up,
                       down=down, padding=pad, gain=3.0)
    assert_op_close(ndhwc(got.numpy()), np.asarray(want))


RESAMPLE_CASES = {  # k, up, down, padding, flip_weight, Cout
    "1x1_down": (1, 1, 2, 0, True, 5),
    "1x1_up": (1, 2, 1, 0, False, 5),
    "down": (3, 1, 2, 1, True, 5),
    "up": (3, 2, 1, 1, False, 5),
    "up_flip": (3, 2, 1, 1, True, 5),
    "up_down": (3, 2, 2, 1, False, 5),
    "plain": (3, 1, 1, 1, True, 5),
    "plain_asym": (3, 1, 1, [1, 0, 2, 1, 0, 1], True, 4),
    "plain_crop": (3, 1, 1, [-1, 1, 0, 0, 1, 2], False, 4),
}


@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_conv3d_resample_matches_jax(jax_lowering, c, case):
    k, up, down, pad, flip_weight, co = RESAMPLE_CASES[case]
    x, w = rand(2, c, 6, 7, 8), rand(k, k, k, c, co)
    want = JR.conv3d_resample(jnp.asarray(ndhwc(x)), jnp.asarray(w),
                              f=JR.setup_filter(), up=up, down=down,
                              padding=pad, flip_weight=flip_weight)
    got = TR.conv3d_resample(torch.from_numpy(x), torch_w(w),
                             f=TR.setup_filter(), up=up, down=down,
                             padding=pad, flip_weight=flip_weight)
    assert_op_close(ndhwc(got.numpy()), np.asarray(want))


@pytest.mark.parametrize("up", [1, 2])
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("demodulate", [True, False])
@pytest.mark.parametrize("fused", [False, True])
def test_modulated_conv3d_matches_jax(fused, demodulate, noise, up):
    n, cin, cout, s = 3, 4, 5, 6
    x, w = rand(n, cin, s, s, s), rand(3, 3, 3, cin, cout)
    styles = 1.0 + rand(n, cin, scale=0.3)
    so = s * up
    nz = rand(n, 1, so, so, so, scale=0.5) if noise else None
    kw = dict(up=up, padding=1, demodulate=demodulate, fused=fused)
    want = JL.modulated_conv3d(
        jnp.asarray(ndhwc(x)), jnp.asarray(w), jnp.asarray(styles),
        noise=None if nz is None else jnp.asarray(ndhwc(nz)),
        resample_filter=JR.setup_filter(), flip_weight=up == 1, **kw)
    got = TL.modulated_conv3d(
        torch.from_numpy(x), torch_w(w), torch.from_numpy(styles),
        noise=None if nz is None else torch.from_numpy(nz),
        resample_filter=TR.setup_filter(), **kw)
    assert_op_close(ndhwc(got.numpy()), np.asarray(want))


@pytest.mark.parametrize("lr_mult,act", [(1.0, "linear"), (0.01, "lrelu")])
def test_fully_connected_matches_jax(lr_mult, act):
    x = rand(3, 7)
    jmod = JL.FullyConnectedLayer(5, activation=act, lr_multiplier=lr_mult,
                                  bias_init=0.5)
    params = {"weight": rand(7, 5) / lr_mult, "bias": rand(5, scale=0.3)}
    want = jmod.apply({"params": params}, jnp.asarray(x))
    mod = TL.FullyConnectedLayer(7, 5, activation=act, lr_multiplier=lr_mult)
    convert._fc(sd := {}, "", params)
    mod.load_state_dict(sd, strict=True)
    got = mod(torch.from_numpy(x)).detach().numpy()
    assert_op_close(got, np.asarray(want))


@pytest.mark.parametrize("psi,cutoff", [(1.0, None), (0.7, None), (0.5, 2)])
def test_mapping_matches_jax(psi, cutoff):
    z = rand(3, 8)
    jmod = JMapping(z_dim=8, w_dim=16, num_ws=4)
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), jnp.zeros((3, 8)))
    params = jax.tree.map(lambda a: rand(*a.shape), shapes["params"])
    params = jax.tree.map(lambda a: a / 0.01 if a.ndim == 2 else a, params)
    w_avg = rand(16, scale=0.5)
    want = jmod.apply({"params": params, "moving": {"w_avg": w_avg}},
                      jnp.asarray(z), truncation_psi=psi,
                      truncation_cutoff=cutoff)
    mod = MappingNetwork(z_dim=8, w_dim=16, num_ws=4)
    sd = {"w_avg": torch.from_numpy(w_avg)}
    for name, p in params.items():
        convert._fc(sd, name, p)
    mod.load_state_dict(sd, strict=True)
    got = mod(torch.from_numpy(z), truncation_psi=psi,
              truncation_cutoff=cutoff).detach().numpy()
    assert got.shape == (3, 4, 16)
    assert_op_close(got, np.asarray(want))
    if cutoff is not None:  # the ws past the cutoff are untruncated
        plain = mod(torch.from_numpy(z)).detach().numpy()
        np.testing.assert_array_equal(got[:, cutoff:], plain[:, cutoff:])


# --- networks ------------------------------------------------------------

def configs(**kw):
    base = dict(stylegan2=True, resolution=16, filterG=16, filterD=16,
                z_size=8, batch_size=8, compute_dtype="float32")
    base.update(kw)
    return JConfig(**base), Config(**base)


def sg2_variables(shapes, rng):
    """A random tree of a StyleGAN2 module's variables, at the scales of
    its own init: weights N(0, 1) (the mapping's divided by its lr_mult
    0.01), affine biases near 1, small biases, nonzero noise strengths and
    w_avg."""
    def fill(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        x = rng.normal(size=leaf.shape)
        if names[-1] == "weight":
            return (x / 0.01 if "mapping" in names else x).astype(np.float32)
        if names[-1] == "bias":
            return (x * 0.1 + ("affine" in names)).astype(np.float32)
        return (x * 0.3).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_variables(jcfg, which, seed=0):
    G, D = jbuild(jcfg)
    r, b = jcfg.resolution, jcfg.batch_size
    if which == "g":
        mod, x = G, jnp.zeros((b, jcfg.z_size))
    else:
        mod, x = D, jnp.zeros((b, r, r, r, 1))
    shapes = jax.eval_shape(mod.init, {"params": jax.random.key(0),
                                       "noise": jax.random.key(1)}, x)
    return mod, sg2_variables(shapes, np.random.default_rng(seed))


@contextlib.contextmanager
def captured_draws(names=("normal",)):
    """Record the JAX package's draws by ``jax.random.<name>`` made while
    active, in call order: concrete arrays when run eagerly, tracers when
    traced (a jitted caller returns them as outputs). flax's abstract
    evaluations of the initializers under ``jax.eval_shape`` are not
    draws and are not recorded."""
    draws, saved, abstract = [], {}, [0]

    def eval_shape(*a, **kw):
        abstract[0] += 1
        try:
            return saved["eval_shape"](*a, **kw)
        finally:
            abstract[0] -= 1

    def recorder(name):
        def record(*a, **kw):
            out = saved[name](*a, **kw)
            if not abstract[0]:
                draws.append(out)
            return out
        return record

    saved["eval_shape"] = jax.eval_shape
    jax.eval_shape = eval_shape
    for name in names:
        saved[name] = getattr(jax.random, name)
        setattr(jax.random, name, recorder(name))
    try:
        yield draws
    finally:
        jax.eval_shape = saved["eval_shape"]
        for name in names:
            setattr(jax.random, name, saved[name])


def port_module(cfg, which, variables):
    G, D = build_models(cfg)
    mod = G if which == "g" else D
    mod.load_state_dict(convert.from_jax_variables(variables, cfg, which),
                        strict=True)
    return mod


@pytest.mark.parametrize("train", [True, False])
def test_generator_matches_jax(train):
    """G at 16^3 (channels 4/2/1): train mode runs the modulated convs
    unfused, eval mode fused (f32); the noise the JAX G draws is injected
    into the port's, converted to NCDHW."""
    jcfg, cfg = configs(batch_size=2)
    G_j, gv = jax_variables(jcfg, "g")
    z = rand(2, cfg.z_size)

    def apply(gv, z):
        with captured_draws() as draws:
            out = G_j.apply(gv, z, train=train,
                            rngs={"noise": jax.random.key(3)})
        return out, draws

    (img_j, ws_j), draws = jax.jit(apply)(gv, jnp.asarray(z))
    img_j, ws_j = np.asarray(img_j), np.asarray(ws_j)
    G = port_module(cfg, "g", gv).train(train)
    shapes = G.synthesis.noise_shapes(2)
    noise = [torch.from_numpy(np.array(ncdhw(d))) for d in draws]
    assert [tuple(n.shape) for n in noise] == shapes
    with torch.no_grad():
        img, ws = G(torch.from_numpy(z), noise=noise)
    assert img.shape == (2, 1, 16, 16, 16)
    assert_op_close(ws.numpy(), ws_j)
    assert_scaled_close(ndhwc(img.numpy()), img_j)


def test_discriminator_matches_jax():
    jcfg, cfg = configs()
    D_j, dv = jax_variables(jcfg, "d")
    x = np.tanh(rand(8, 1, 16, 16, 16))
    x[1::2] *= 0.2     # the samples' statistics differ across groups
    want = np.asarray(jax.jit(D_j.apply)(dv, jnp.asarray(ndhwc(x))))
    D = port_module(cfg, "d", dv)
    with torch.no_grad():
        got = D(torch.from_numpy(x)).numpy()
    assert got.shape == (8, 1) and got.dtype == np.float32
    assert_scaled_close(got, want)


def test_minibatch_std_groups_follow_jax():
    """Batch 8, groups of 4, odd samples scaled x10. The JAX layer (and
    so the port's) splits the batch as [4, 2] (sample s in group s % 2)
    but spreads the two statistics with ``repeat``: samples 0-3 get group
    0's, 4-7 group 1's. The reference's torch layer tiles them
    (``y.repeat(G, 1, D, H, W)``), so there sample s gets group s % 2's:
    [a, b, a, b, ...]. This pins the JAX assignment (ROADMAP C)."""
    x = rand(8, 3, 2, 2, 2)
    x[1::2] *= 10.0
    want = np.asarray(JMinibatchStd(4, 1).apply({}, jnp.asarray(ndhwc(x))))
    got = MinibatchStdLayer(4, 1)(torch.from_numpy(x)).numpy()
    assert got.shape == (8, 4, 2, 2, 2)
    assert_op_close(ndhwc(got), want)
    stat = got[:, 3, 0, 0, 0]
    even, odd = stat[0], stat[4]
    assert odd > 5 * even
    np.testing.assert_allclose(stat, [even] * 4 + [odd] * 4, rtol=1e-6)
    np.testing.assert_array_equal(got[:, :3], x)


@pytest.mark.parametrize("which", ["g", "d"])
def test_from_jax_variables_matches_export(which):
    jcfg, cfg = configs()
    _, variables = jax_variables(jcfg, which)
    variables = jax.tree.map(np.asarray, variables)
    export = export_stylegan2_g if which == "g" else export_stylegan_d
    want = export(variables, jcfg)
    got = convert.from_jax_variables(variables, cfg, which)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    G, D = build_models(cfg)
    (G if which == "g" else D).load_state_dict(got, strict=True)


def test_noise_modes():
    """noise_mode='random' needs the noise or a generator (no draw from
    the global RNG); 'const' (no caller in either package) is not ported."""
    _, cfg = configs(batch_size=2)
    G, _ = build_models(cfg)
    z = torch.zeros(2, cfg.z_size)
    state = torch.random.get_rng_state()
    with pytest.raises(ValueError, match="generator"):
        G(z)
    with pytest.raises(NotImplementedError, match="not ported"):
        G(z, noise_mode="const")
    for m in G.modules():  # the init's noise strengths are 0
        if hasattr(m, "noise_strength"):
            torch.nn.init.constant_(m.noise_strength, 0.5)
    with torch.no_grad():
        a, _ = G(z, generator=torch.Generator().manual_seed(0))
        b, _ = G(z, generator=torch.Generator().manual_seed(0))
        c, _ = G(z, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(torch.random.get_rng_state(), state)

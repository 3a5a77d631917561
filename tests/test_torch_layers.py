"""The port's layers against the JAX package's, in f32 train mode.

SNConv3d / SNLinear (output and power-iteration state after one and two
forwards), BatchNorm3d (output and running stats, train and eval), and
SelfAttention3d with gamma != 0 (output, SN state, input gradient). JAX
variables are made by the JAX modules, carried across with
gan3d_tpu_torch.convert, and loaded with strict=True; inputs are numpy
arrays from a seed. Tolerance: atol 1e-5 / rtol 1e-4 unless stated (f32,
different summation orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan3d_tpu.nn import BatchNorm3d as JBatchNorm3d
from gan3d_tpu.nn import SelfAttention3d as JSelfAttention3d
from gan3d_tpu.nn import SNConv3d as JSNConv3d
from gan3d_tpu.nn import SNLinear as JSNLinear
from gan3d_tpu_torch import convert
from gan3d_tpu_torch.nn import BatchNorm3d, SelfAttention3d, SNConv3d, SNLinear

torch.set_num_threads(1)

RNG = np.random.default_rng(11)
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def jax_reference_lowering(monkeypatch):
    """The JAX package keeps its lowering choices (the TPU conv rewrites,
    the Pallas kernels, the attention impl) in module globals that other
    test files may leave set in this worker. Pin the plain XLA lowering for
    each test and restore the previous values after it."""
    from gan3d_tpu.ops import (attention, downsample_conv, dw_conv,
                               lane_conv, s2d_conv, subpixel_conv, tap_conv,
                               upsample_conv, wide_conv)

    for mod in (lane_conv, wide_conv, dw_conv, s2d_conv, tap_conv,
                subpixel_conv, upsample_conv, downsample_conv):
        monkeypatch.setattr(mod, "_MODE", "off")
    monkeypatch.setattr(subpixel_conv, "_WIDE_MODE", "off")
    monkeypatch.setattr(downsample_conv, "_VJP_MODE", "autodiff")
    monkeypatch.setattr(attention, "_FORCE_IMPL", None)


def rand(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def to_np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def ndhwc(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def unit(n):
    u = rand(n)
    return u / np.linalg.norm(u)


def apply_jax(mod, variables, x, **kw):
    params = variables["params"]
    state = {k: v for k, v in variables.items() if k != "params"}
    out, new_state = mod.apply({"params": params, **state}, x,
                               mutable=list(state), **kw)
    return np.asarray(out), {"params": params, **to_np(new_state)}


@pytest.mark.parametrize("k,pad", [(3, 1), (1, 0)])
def test_snconv3d_output_and_state_two_forwards(k, pad):
    x = rand(2, 4, 6, 6, 6)
    jmod = JSNConv3d(6, kernel_size=k, padding=pad)
    jv = to_np(jmod.init(jax.random.key(0), jnp.asarray(ndhwc(x))))
    # Random (u, v): the 15-step warm start is near-stationary, so one and
    # two further steps would be indistinguishable.
    jv["spectral"] = {"u": unit(6), "v": unit(4 * k ** 3)}
    sd = {}
    convert.conv_state(sd, "", jv["params"], jv["spectral"])
    tmod = SNConv3d(4, 6, k, padding=pad)
    tmod.load_state_dict(sd, strict=True)
    pn = tmod.parametrizations.weight[0]
    for _ in range(2):
        y_j, jv = apply_jax(jmod, jv, jnp.asarray(ndhwc(x)))
        y_t = tmod(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(ndhwc(y_t), y_j, **TOL)
        np.testing.assert_allclose(pn._u.numpy(), jv["spectral"]["u"], **TOL)
        np.testing.assert_allclose(pn._v.numpy(), jv["spectral"]["v"], **TOL)


def test_snlinear_output_and_state_two_forwards():
    x = rand(3, 10)
    jmod = JSNLinear(7)
    jv = to_np(jmod.init(jax.random.key(1), jnp.asarray(x)))
    jv["spectral"] = {"u": unit(7), "v": unit(10)}
    sd = {}
    convert.linear_state(sd, "", jv["params"], jv["spectral"])
    tmod = SNLinear(10, 7)
    tmod.load_state_dict(sd, strict=True)
    pn = tmod.parametrizations.weight[0]
    for _ in range(2):
        y_j, jv = apply_jax(jmod, jv, jnp.asarray(x))
        y_t = tmod(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(y_t, y_j, **TOL)
        np.testing.assert_allclose(pn._u.numpy(), jv["spectral"]["u"], **TOL)
        np.testing.assert_allclose(pn._v.numpy(), jv["spectral"]["v"], **TOL)


def test_sn_eval_mode_does_not_step():
    """Eval mode (JAX update_stats=False) leaves u/v alone."""
    tmod = SNConv3d(4, 6, 3, padding=1).eval()
    u0 = tmod.parametrizations.weight[0]._u.clone()
    tmod(torch.from_numpy(rand(1, 4, 4, 4, 4)))
    assert torch.equal(tmod.parametrizations.weight[0]._u, u0)


def test_batchnorm3d_train_and_eval():
    c = 5
    x = rand(3, c, 4, 5, 6) * 2 + 0.5
    jmod = JBatchNorm3d(c)
    jv = to_np(jmod.init(jax.random.key(2), jnp.asarray(ndhwc(x))))
    jv["params"] = {"scale": rand(c), "bias": rand(c)}
    jv["batch_stats"] = {"mean": rand(c), "var": np.abs(rand(c)) + 0.5}
    sd = {}
    convert.bn_state(sd, "", jv["params"], jv["batch_stats"])
    tmod = BatchNorm3d(c)
    tmod.load_state_dict(sd, strict=True)
    # train: batch statistics, running stats updated (unbiased variance)
    y_j, jv2 = apply_jax(jmod, jv, jnp.asarray(ndhwc(x)))
    y_t = tmod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(ndhwc(y_t), y_j, **TOL)
    np.testing.assert_allclose(tmod.running_mean.numpy(),
                               jv2["batch_stats"]["mean"], **TOL)
    np.testing.assert_allclose(tmod.running_var.numpy(),
                               jv2["batch_stats"]["var"], **TOL)
    # eval: running statistics
    y_j = jmod.apply({"params": jv2["params"],
                      "batch_stats": jv2["batch_stats"]},
                     jnp.asarray(ndhwc(x)), use_running_average=True)
    y_t = tmod.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(ndhwc(y_t), np.asarray(y_j), **TOL)


def test_self_attention3d_gamma_nonzero():
    """gamma = 0.7 (a fresh block has gamma = 0 and is the identity). 8^3
    grid: L=512, M=64, c=2. Output and every SN state after one forward,
    and the gradient of sum(y^2) with respect to the input (atol 1e-4 /
    rtol 1e-3: a longer f32 chain)."""
    ch = 16
    x = rand(2, ch, 8, 8, 8)
    jmod = JSelfAttention3d(ch)
    jv = to_np(jmod.init(jax.random.key(3), jnp.asarray(ndhwc(x))))
    jv["params"]["gamma"] = np.float32(0.7)
    sd = {}
    convert.attention_state(sd, "", jv["params"], jv["spectral"])
    tmod = SelfAttention3d(ch)
    tmod.load_state_dict(sd, strict=True)

    y_j, jv2 = apply_jax(jmod, jv, jnp.asarray(ndhwc(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = tmod(xt)
    np.testing.assert_allclose(ndhwc(y_t.detach().numpy()), y_j, **TOL)
    for name in ("f", "g", "h", "v"):
        pn = getattr(tmod, name).parametrizations.weight[0]
        np.testing.assert_allclose(pn._u.numpy(),
                                   jv2["spectral"][name]["u"], **TOL)
        np.testing.assert_allclose(pn._v.numpy(),
                                   jv2["spectral"][name]["v"], **TOL)

    def loss(xj):
        out, _ = jmod.apply(jv, xj, mutable=["spectral"])
        return jnp.sum(out ** 2)

    g_j = jax.grad(loss)(jnp.asarray(ndhwc(x)))
    (y_t ** 2).sum().backward()
    np.testing.assert_allclose(ndhwc(xt.grad.numpy()), np.asarray(g_j),
                               atol=1e-4, rtol=1e-3)

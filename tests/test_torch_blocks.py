"""The port's BigGAN-deep blocks against the JAX package's, in f32.

GBlockDeep with and without upsample and channel drop; DBlockDeep with and
without downsample and the concatenated shortcut. One train-mode forward:
output, every BN running stat and SN vector afterwards, and the gradient of
sum(y^2) with respect to the input. Weights are carried across with
gan3d_tpu_torch.convert; inputs are numpy arrays from a seed. Tolerance:
atol 1e-5 / rtol 1e-4 for outputs and state, atol 1e-4 / rtol 1e-3 for the
input gradient (f32, different summation orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan3d_tpu.nn import DBlockDeep as JDBlockDeep
from gan3d_tpu.nn import GBlockDeep as JGBlockDeep
from gan3d_tpu_torch import convert
from gan3d_tpu_torch.nn import DBlockDeep, GBlockDeep

from test_torch_layers import jax_reference_lowering  # noqa: F401,E402

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)


def to_np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def ndhwc(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def randomize_bn(variables, rng):
    """Non-trivial BN affine and running stats, so every leaf is tested."""
    for name, p in variables["params"].items():
        if name.startswith("bn"):
            c = p["scale"].shape[0]
            p["scale"] = rng.normal(size=c).astype(np.float32)
            p["bias"] = rng.normal(size=c).astype(np.float32)
            st = variables["batch_stats"][name]
            st["mean"] = rng.normal(size=c).astype(np.float32)
            st["var"] = (np.abs(rng.normal(size=c)) + 0.5).astype(np.float32)


def check_sn_state(tmod, spectral, prefix=""):
    for name, st in spectral.items():
        pn = getattr(tmod, name).parametrizations.weight[0]
        np.testing.assert_allclose(pn._u.numpy(), st["u"], **TOL,
                                   err_msg=f"{prefix}{name}.u")
        np.testing.assert_allclose(pn._v.numpy(), st["v"], **TOL,
                                   err_msg=f"{prefix}{name}.v")


def run_pair(jmod, tmod, x, variables, sd, mutable, jkw):
    tmod.load_state_dict(sd, strict=True)
    y_j, new_state = jmod.apply(variables, jnp.asarray(ndhwc(x)),
                                mutable=mutable, **jkw)
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y_t = tmod(xt)
    np.testing.assert_allclose(ndhwc(y_t.detach().numpy()), np.asarray(y_j),
                               **TOL)

    def loss(xj):
        out, _ = jmod.apply(variables, xj, mutable=mutable, **jkw)
        return jnp.sum(out ** 2)

    g_j = jax.grad(loss)(jnp.asarray(ndhwc(x)))
    (y_t ** 2).sum().backward()
    np.testing.assert_allclose(ndhwc(xt.grad.numpy()), np.asarray(g_j),
                               atol=1e-4, rtol=1e-3)
    return to_np(new_state)


@pytest.mark.parametrize("cin,cout,up", [(16, 16, False), (16, 8, True),
                                         (16, 16, True), (16, 8, False)])
def test_gblockdeep(cin, cout, up):
    rng = np.random.default_rng(cin + cout + up)
    x = rng.normal(size=(2, cin, 4, 4, 4)).astype(np.float32)
    jmod = JGBlockDeep(cin, cout, upsample=up)
    variables = to_np(jmod.init(jax.random.key(0), jnp.asarray(ndhwc(x))))
    randomize_bn(variables, rng)
    sd = {}
    convert.deep_block_state(sd, "", variables["params"],
                             variables["batch_stats"], variables["spectral"])
    tmod = GBlockDeep(cin, cout, upsample=up)
    new = run_pair(jmod, tmod, x, variables, sd, ["batch_stats", "spectral"],
                   {})
    for name, st in new["batch_stats"].items():
        bn = getattr(tmod, name)
        np.testing.assert_allclose(bn.running_mean.numpy(), st["mean"], **TOL)
        np.testing.assert_allclose(bn.running_var.numpy(), st["var"], **TOL)
    check_sn_state(tmod, new["spectral"])


@pytest.mark.parametrize("cin,cout,down", [(8, 16, True), (16, 16, False),
                                           (16, 16, True), (8, 16, False)])
def test_dblockdeep(cin, cout, down):
    rng = np.random.default_rng(cin + cout + down)
    x = rng.normal(size=(2, cin, 8, 8, 8)).astype(np.float32)
    jmod = JDBlockDeep(cin, cout, downsample=down)
    variables = to_np(jmod.init(jax.random.key(1), jnp.asarray(ndhwc(x))))
    sd = {}
    convert.deep_block_state(sd, "", variables["params"], None,
                             variables["spectral"])
    tmod = DBlockDeep(cin, cout, downsample=down)
    assert (tmod.conv_sc is not None) == (cin != cout)
    new = run_pair(jmod, tmod, x, variables, sd, ["spectral"], {})
    check_sn_state(tmod, new["spectral"])

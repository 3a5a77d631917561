"""The port's BigGAN G and D against the JAX package's, and the weight
conversion against the JAX package's own torch export.

- ``convert.from_jax_variables`` must equal ``gan3d_tpu.eval.export``'s
  ``export_biggan_g/d`` key for key and value for value (exact), and load
  into the port's modules with strict=True, for the biggan, sagan and
  sngan variants.
- G and D at resolution 32, filters 8, biggan=True (G attention at 32^3,
  D attention at 16^3), attention gamma set non-zero: one train-mode
  forward, output and every BN/SN leaf afterwards. Tolerance atol 1e-4 /
  rtol 1e-3 on outputs scaled to unit maximum (f32 through ~50 layers with
  batch-2 BN statistics, summed in different orders; the JAX package's own
  torch oracle uses the same, tests/test_convert.py) and atol 1e-5 /
  rtol 1e-4 on the state leaves.

The JAX variables are random trees of the JAX modules' own structure
(``jax.eval_shape`` of their init), filled from a numpy seed: the init's
warm-start program takes ~20 s to compile on the CPU and adds nothing here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan3d_tpu.config import Config as JConfig
from gan3d_tpu.eval.export import export_biggan_d, export_biggan_g
from gan3d_tpu.models import build_models as jbuild
from gan3d_tpu_torch import convert
from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models import build_models

from test_torch_layers import jax_reference_lowering  # noqa: F401,E402

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
OUT_TOL = dict(atol=1e-4, rtol=1e-3)
VARIANTS = {
    "biggan": dict(biggan=True),
    "sagan": dict(sagan=True),
    "sngan_biggan": dict(sngan=True, biggan=True),
}


def configs(**kw):
    base = dict(resolution=32, filterG=8, filterD=8, z_size=16, batch_size=2,
                compute_dtype="float32", hinge=True)
    base.update(kw)
    return JConfig(**base), Config(**base)


def to_np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def random_variables(shapes, rng):
    """Fill a variable tree of ShapeDtypeStructs: unit SN vectors, positive
    BN variances, BN scales near 1, attention gamma 0.5, the rest N(0, 0.1).
    """
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


def jax_variables(jcfg, which, seed=0):
    G, D = jbuild(jcfg)
    mod = G if which == "g" else D
    x = (jnp.zeros((2, jcfg.z_size)) if which == "g" else
         jnp.zeros((2, jcfg.resolution, jcfg.resolution, jcfg.resolution, 1)))
    shapes = jax.eval_shape(mod.init, {"params": jax.random.key(0)}, x)
    return mod, random_variables(shapes, np.random.default_rng(seed))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("which", ["g", "d"])
def test_convert_equals_export(variant, which):
    jcfg, cfg = configs(**VARIANTS[variant])
    _, variables = jax_variables(jcfg, which)
    export = export_biggan_g if which == "g" else export_biggan_d
    want = export(variables, jcfg)
    got = convert.from_jax_variables(variables, cfg, which)
    assert list(got) == list(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    G, D = build_models(cfg)
    (G if which == "g" else D).load_state_dict(got, strict=True)


def check_state(module, jcfg, which, new_state, params):
    """Every BN running stat and SN vector, via the same conversion."""
    variables = {"params": params, **new_state}
    want = convert.from_jax_variables(variables, jcfg, which)
    got = module.state_dict()
    n = 0
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var", "._u", "._v")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       **TOL, err_msg=key)
            n += 1
    assert n > 0


def test_generator_forward_and_state():
    jcfg, cfg = configs(biggan=True)
    G_j, variables = jax_variables(jcfg, "g", seed=1)
    G, _ = build_models(cfg)
    G.load_state_dict(convert.from_jax_variables(variables, cfg, "g"),
                      strict=True)
    z = np.random.default_rng(2).normal(size=(2, 16)).astype(np.float32)
    params = variables["params"]
    state = {k: v for k, v in variables.items() if k != "params"}
    y_j, new_state = jax.jit(lambda v, z: G_j.apply(
        v, z, train=True, mutable=list(state)))(variables, jnp.asarray(z))
    y_t = G.train()(torch.from_numpy(z)).detach().numpy()
    assert y_t.shape == (2, 1, 32, 32, 32)
    scale = np.abs(np.asarray(y_j)).max()
    np.testing.assert_allclose(np.moveaxis(y_t, 1, -1) / scale,
                               np.asarray(y_j) / scale, **OUT_TOL)
    check_state(G, cfg, "g", to_np(new_state), params)
    assert state["batch_stats"]


def test_discriminator_forward_and_state():
    jcfg, cfg = configs(biggan=True)
    D_j, variables = jax_variables(jcfg, "d", seed=3)
    _, D = build_models(cfg)
    D.load_state_dict(convert.from_jax_variables(variables, cfg, "d"),
                      strict=True)
    x = np.tanh(np.random.default_rng(4).normal(size=(2, 1, 32, 32, 32))
                ).astype(np.float32)
    params = variables["params"]
    y_j, new_state = jax.jit(lambda v, x: D_j.apply(
        v, x, mutable=["spectral"]))(variables,
                                     jnp.asarray(np.moveaxis(x, 1, -1)))
    y_t = D.train()(torch.from_numpy(x)).detach().numpy()
    scale = np.abs(np.asarray(y_j)).max()
    np.testing.assert_allclose(y_t / scale, np.asarray(y_j) / scale,
                               **OUT_TOL)
    check_state(D, cfg, "d", to_np(new_state), params)

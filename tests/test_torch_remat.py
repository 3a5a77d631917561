"""Rematerialization (``cfg.remat``, gan3d_tpu_torch/nn/remat.py) in the
port, against the port without it and against the JAX package.

The checkpoint helper must keep what flax's lifted ``nn.remat`` keeps
(tests/test_remat_scope.py, tests/test_sn_dynamics.py): every
spectral-norm ``_u`` / ``_v`` and BN running stat steps once per forward,
and the recompute in backward sees the vectors the forward saw. Here D
runs twice before the backward (as D(real) and D(fake) do in the step),
so its vectors move between its forward and the recompute, and the SN
vectors start from random unit vectors (the init's 15 warm-start
iterations leave them near-stationary, where a wrong count would hide).

- BigGAN ``--biggan --sagan`` at 32^3 (attention at 32^3 in G, 16^3 in
  D) and 16^3, ``remat_scope`` block and stage, f32: G's and D's outputs
  within 1e-6, every gradient within 1e-6 (rtol 1e-5) and the summed
  |grad| within rtol 1e-5, every SN vector and BN running stat within
  1e-6 of the run without remat; the plain attention called as often;
  the state_dict keys unchanged. (On the CPU all of these come out
  bit-equal: the recompute repeats the same f32 operations.)
- without the helper's state swap, torch's checkpoint alone steps the
  state twice: the same comparison fails (the test can see the fault);
- the DCGAN family ignores the flag, as in the JAX package;
- the fused WGAN-GP step (a double backward through the groups), and the
  StyleGAN2 (lazy with ``sg2_reg_grads=True``, and plain) and StyleGAN-1
  steps, with remat against without: every parameter, buffer and loss
  within 1e-6;
- the port's fused step with remat (block and stage) against the JAX
  fused step with ``remat=True, remat_scope="stage"`` at 16^3, with
  ``test_torch_step``'s tolerances, and the SN update count of a conv in
  a remat group replayed as ``tests/test_sn_dynamics.py`` does: G's
  vectors advance 3 power steps in a step (2 D-update forwards and the G
  update), not 4.
"""

import numpy as np
import pytest
import torch

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models import build_models
from gan3d_tpu_torch.models.stylegan import loss as sg_loss
from gan3d_tpu_torch.nn import attention as nn_attention
from gan3d_tpu_torch.nn import remat
from gan3d_tpu_torch.train.state import Adam
from gan3d_tpu_torch.train.step import train_step

from test_torch_layers import (jax_reference_lowering,  # noqa: F401,E402
                               pin_reference_lowering)
from test_torch_step import jax_step, port_step_matches  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-5)
BIGGAN = dict(biggan=True, sagan=True, hinge=True, filterG=8, filterD=8,
              z_size=16, batch_size=2, compute_dtype="float32")
STATE = ("._u", "._v", "running_mean", "running_var")


def rerandom(net: torch.nn.Module, seed: int) -> None:
    """Every SN vector a random unit vector."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith(("._u", "._v")):
                u = rng.normal(size=buf.shape)
                buf.copy_(torch.from_numpy(u / np.linalg.norm(u)))


def forward_backward(cfg: Config, monkeypatch) -> dict:
    """G(z), D(fake), then D(real) before the backward of both; returns
    the outputs, the gradients, the state_dicts and the attention calls."""
    calls = []
    plain = nn_attention.pooled_attention

    def counted(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(nn_attention, "pooled_attention", counted)
    G, D = build_models(cfg)
    rerandom(G, 1)
    rerandom(D, 2)
    rng = np.random.default_rng(3)
    r = cfg.resolution
    z = torch.from_numpy(rng.normal(size=(2, cfg.z_size)).astype(np.float32))
    real = torch.from_numpy(np.tanh(rng.normal(size=(2, 1, r, r, r))).astype(
        np.float32))
    fake = G.train()(z)
    d_fake = D.train()(fake)
    d_real = D(real)
    params = list(G.parameters()) + list(D.parameters())
    grads = torch.autograd.grad(d_fake.sum() - (d_real ** 2).sum(), params)
    monkeypatch.setattr(nn_attention, "pooled_attention", plain)
    return {"fake": fake.detach(), "d": torch.cat([d_fake, d_real]).detach(),
            "grads": grads, "g": G.state_dict(), "d_sd": D.state_dict(),
            "calls": calls}


def assert_same(got: dict, ref: dict) -> None:
    for k in ("fake", "d"):
        torch.testing.assert_close(got[k], ref[k], **TOL)
    for a, b in zip(got["grads"], ref["grads"]):
        torch.testing.assert_close(a, b, **TOL)
    total = [sum(float(g.abs().sum()) for g in run["grads"])
             for run in (got, ref)]
    np.testing.assert_allclose(total[0], total[1], rtol=1e-5)
    for k in ("g", "d_sd"):
        assert list(got[k]) == list(ref[k])
        n = 0
        for name, value in ref[k].items():
            if name.endswith(STATE):
                torch.testing.assert_close(got[k][name], value, **TOL,
                                           msg=f"{k} {name}")
                n += 1
        assert n > 0
    assert got["calls"] == ref["calls"]


_REFS = {}


def reference(res: int, monkeypatch) -> dict:
    if res not in _REFS:
        _REFS[res] = forward_backward(Config(resolution=res, **BIGGAN),
                                      monkeypatch)
    return _REFS[res]


@pytest.mark.parametrize("scope", ["block", "stage"])
@pytest.mark.parametrize("res", [32, 16])
def test_biggan_remat_matches_no_remat(res, scope, monkeypatch):
    ref = reference(res, monkeypatch)
    # 32^3: G's attention at 32^3, D's at 16^3 (twice); 16^3: none
    assert len(ref["calls"]) == (3 if res == 32 else 0)
    got = forward_backward(Config(resolution=res, remat=True,
                                  remat_scope=scope, **BIGGAN), monkeypatch)
    assert_same(got, ref)


def test_checkpoint_without_the_state_swap_steps_twice(monkeypatch):
    """torch's checkpoint alone (the swap made a no-op) re-runs the
    groups' forwards on the modules' own state: SN vectors of G and D come
    out other than without remat."""
    ref = reference(16, monkeypatch)
    monkeypatch.setattr(remat, "group_state", lambda modules: [])
    got = forward_backward(Config(resolution=16, remat=True,
                                  remat_scope="stage", **BIGGAN), monkeypatch)
    for k in ("g", "d_sd"):
        moved = [name for name, v in ref[k].items()
                 if name.endswith(("._u", "._v"))
                 and not torch.allclose(got[k][name], v, **TOL)]
        assert moved, k


@pytest.mark.parametrize("net,scope,runs", [
    ("G", "", [1, 1, 1, 1]), ("G", "block", [2, 2, 2, 2]),
    ("G", "stage", [3, 2, 3, 3]), ("D", "", [1, 1, 1, 1]),
    ("D", "block", [2, 2, 2, 2]), ("D", "stage", [3, 2, 3, 2])],
    ids=["G-none", "G-block", "G-stage", "D-none", "D-block", "D-stage"])
def test_deep_block_forwards_per_scope(net, scope, runs, monkeypatch):
    """How often a forward and backward run each deep block's forward, at
    16^3 (two stages of two blocks): once without remat, twice per block
    (its group's recompute). Per stage, the stage group's recompute
    checkpoints each block again (``remat.nested``), so backward holds one
    stage's block boundaries at a time, never all of a stage's
    activations: a block runs three times, but the last group of a stage
    twice, since torch's recompute stops once it has that group's input
    (in G's last stage the last group is the out-head)."""
    from gan3d_tpu_torch.nn.blocks import DBlockDeep, GBlockDeep

    calls = {}
    for cls in (GBlockDeep, DBlockDeep):
        def counted(self, x, _plain=cls.forward):
            calls[id(self)] = calls.get(id(self), 0) + 1
            return _plain(self, x)
        monkeypatch.setattr(cls, "forward", counted)
    cfg = Config(resolution=16, remat=bool(scope),
                 remat_scope=scope or "block", **BIGGAN)
    G, D = build_models(cfg)
    if net == "G":
        out = G.train()(torch.zeros((2, cfg.z_size)) + 0.5)
    else:
        out = D.train()(torch.full((2, 1, 16, 16, 16), 0.5))
    out.sum().backward()
    blocks = [m for m in (G if net == "G" else D).modules()
              if isinstance(m, (GBlockDeep, DBlockDeep))]
    assert [calls.get(id(m)) for m in blocks] == runs


def test_remat_scope_outside_block_and_stage_raises():
    with pytest.raises(ValueError, match="remat_scope"):
        build_models(Config(resolution=16, remat=True, remat_scope="layer",
                            **BIGGAN))


@pytest.mark.parametrize("kw", [dict(dcgan=True), dict(dcgan=True,
                                                        sagan=True)])
def test_dcgan_takes_no_remat(kw, monkeypatch):
    """gan3d_tpu/models/dcgan.py never reads cfg.remat: with the flag the
    port's DCGAN G and D run no group and compute the same."""
    cfg = Config(resolution=16, filterG=8, filterD=8, z_size=8,
                 compute_dtype="float32", **kw)
    z = torch.randn((2, 8, 1, 1, 1), generator=torch.Generator().manual_seed(0))
    G, D = build_models(cfg)
    want = D.train()(G.train()(z))

    def refuse(*args):
        raise AssertionError("a DCGAN network ran a remat group")

    monkeypatch.setattr(remat, "checkpoint", refuse)
    G, D = build_models(cfg.replace(remat=True, remat_scope="stage"))
    torch.testing.assert_close(D.train()(G.train()(z)), want, rtol=0, atol=0)


def _after_step(cfg: Config, step_fn) -> dict:
    G, D = build_models(cfg)
    rerandom(G, 1)
    rerandom(D, 2)
    g_opt = Adam(G.parameters(), cfg.lrG, 0.0, 0.9)
    d_opt = Adam(D.parameters(), cfg.lrD, 0.0, 0.9)
    metrics, extra = step_fn(G.train(), D.train(), g_opt, d_opt)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "extra": extra, "g": G.state_dict(), "d": D.state_dict()}


def assert_steps_equal(got: dict, ref: dict) -> None:
    np.testing.assert_allclose([got["metrics"][k] for k in sorted(ref[
        "metrics"])], [ref["metrics"][k] for k in sorted(ref["metrics"])],
        atol=1e-6, rtol=0)
    torch.testing.assert_close(got["extra"], ref["extra"], atol=1e-6, rtol=0)
    for k in ("g", "d"):
        assert list(got[k]) == list(ref[k])
        for name, value in ref[k].items():
            torch.testing.assert_close(got[k][name], value, atol=1e-6,
                                       rtol=0, msg=f"{k} {name}")


def _reals(cfg: Config, seed: int = 4) -> torch.Tensor:
    r = cfg.resolution
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.tanh(rng.normal(
        size=(cfg.iterD, cfg.batch_size, 1, r, r, r))).astype(np.float32))


@pytest.mark.parametrize("scope", ["block", "stage"])
def test_wgan_gp_step_with_remat_matches_without(scope):
    """The gradient penalty differentiates D twice, through its groups."""
    cfg = Config(resolution=16, filterG=8, filterD=8, z_size=8, batch_size=2,
                 iterD=2, biggan=True, gp_weight=10.0,
                 compute_dtype="float32")
    reals = _reals(cfg)

    def step(G, D, g_opt, d_opt):
        metrics, fake = train_step(cfg, G, D, g_opt, d_opt, reals,
                                   generator=torch.Generator().manual_seed(5))
        return metrics, fake

    ref = _after_step(cfg, step)
    cfg_r = cfg.replace(remat=True, remat_scope=scope)
    got = _after_step(cfg_r, lambda G, D, g, d: train_step(
        cfg_r, G, D, g, d, reals, generator=torch.Generator().manual_seed(5)))
    assert_steps_equal(got, ref)


SG = dict(resolution=16, filterG=16, filterD=16, z_size=8, batch_size=4,
          iterD=2, compute_dtype="float32")


@pytest.mark.parametrize("family,step,reg_grads", [
    ("stylegan2", 0, True), ("stylegan2", 1, False), ("stylegan", 0, True)])
def test_stylegan_step_with_remat_matches_without(family, step, reg_grads):
    """StyleGAN2's synthesis blocks and the D's blocks as groups: the lazy
    step with sg2_reg_grads=True runs R1's and PL's double backward
    through them; StyleGAN-1 (R1 every step) takes the D's groups."""
    cfg = Config(**{family: True}, sg2_reg_grads=reg_grads, **SG)
    reals = _reals(cfg)

    def stepper(c):
        def run(G, D, g_opt, d_opt):
            ema = ([p.detach().clone() for p in G.parameters()]
                   if family == "stylegan2" else [])
            metrics, img, pl_mean = sg_loss.train_step(
                c, G, D, g_opt, d_opt, reals, step, ema, torch.tensor(0.25),
                generator=torch.Generator().manual_seed(6))
            return metrics, torch.cat([img.flatten(), pl_mean.reshape(1)])
        return run

    ref = _after_step(cfg, stepper(cfg))
    cfg_r = cfg.replace(remat=True)
    got = _after_step(cfg_r, stepper(cfg_r))
    assert_steps_equal(got, ref)


@pytest.mark.parametrize("remat_on", [False, True], ids=["plain", "remat"])
def test_synthesis_without_noise_or_generator_raises(remat_on, monkeypatch):
    """Without the noise or a generator the synthesis raises before its
    first block: no group ever draws the noise itself (the recompute would
    draw other values)."""
    from gan3d_tpu_torch.models.stylegan.generator import SynthesisBlock

    def refuse(*args, **kwargs):
        raise AssertionError("a synthesis block ran")

    monkeypatch.setattr(SynthesisBlock, "forward", refuse)
    G, _ = build_models(Config(stylegan2=True, remat=remat_on, **SG))
    ws = G.map_ws(torch.zeros((2, SG["z_size"])))
    with pytest.raises(ValueError, match="needs the noise or a generator"):
        G.synthesize(ws)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
JCFG = dict(resolution=16, filterG=8, filterD=8, z_size=16, batch_size=2,
            iterD=2, biggan=True, hinge=True, compute_dtype="float32")


_JAX = {}


def jax_remat_step():
    """The JAX fused step with remat per stage, traced, compiled and run in
    a worker thread; started once, at the module's first test
    (``_jax_remat_reference``)."""
    if "stage" not in _JAX:
        _JAX["stage"] = jax_step(dict(JCFG, remat=True, remat_scope="stage"))
    return _JAX["stage"]


@pytest.fixture(scope="module", autouse=True)
def _jax_remat_reference():
    """Starts ``jax_remat_step`` before the module's first test, so that
    its compile runs beside them, under the reference lowering pinned for
    the whole module (each test's own pin, jax_reference_lowering, then
    restores these values); waits for it before the module's pin is
    undone."""
    with pytest.MonkeyPatch.context() as mp:
        pin_reference_lowering(mp)
        pending = jax_remat_step()[-1]
        yield
        pending.result()


def power_steps(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                n: int) -> torch.Tensor:
    """u after n power steps of torch's spectral norm on ``w``."""
    mat = w.flatten(1)
    for _ in range(n):
        u = torch.nn.functional.normalize(mat @ v, dim=0, eps=1e-12)
        v = torch.nn.functional.normalize(mat.T @ u, dim=0, eps=1e-12)
    return u


@pytest.mark.parametrize("scope", ["block", "stage"])
def test_fused_step_with_remat_matches_jax(scope):
    from gan3d_tpu_torch import convert

    cfg = Config(**JCFG, remat=True, remat_scope=scope)
    ref = jax_remat_step()
    port_step_matches(cfg, ref)

    # the SN update count of a conv inside a group (G's first deep block)
    gv, dv, reals, noise, _, _ = ref
    G, D = build_models(cfg)
    G.load_state_dict(convert.from_jax_variables(gv, cfg, "g"), strict=True)
    D.load_state_dict(convert.from_jax_variables(dv, cfg, "d"), strict=True)
    conv = G.blocks[0][0].conv2.parametrizations.weight
    w0, u0, v0 = (t.detach().clone() for t in (conv.original, conv[0]._u,
                                               conv[0]._v))
    train_step(cfg, G.train(), D.train(), Adam(G.parameters(), cfg.lrG, 0.0,
                                               0.9),
               Adam(D.parameters(), cfg.lrD, 0.0, 0.9),
               torch.from_numpy(reals),
               noises=[torch.from_numpy(n) for n in noise])
    u1 = conv[0]._u
    torch.testing.assert_close(u1, power_steps(w0, u0, v0, 3), atol=1e-5,
                               rtol=0)
    assert not torch.allclose(u1, power_steps(w0, u0, v0, 4), atol=1e-6)

"""The split D/G step (``cfg.fused_step=False``): the JAX split steps
against the port's step, and the trainer that takes the flag.

- the port's step, iterD ``d_step`` calls and one ``g_step`` call
  (train/step.py), against the JAX split steps
  (``gan3d_tpu.train.step.build_split_steps``) at 16^3 with
  ``test_torch_step``'s tolerances: the hinge step and the WGAN step with
  the gradient penalty;
- the train CLI with ``--fused_step=False --remat=True`` at 16^3 on the
  CPU: 2 steps and a resume to 3; its checkpoint after 2 steps equal to
  the default run's (the flag changes nothing in the port); StyleGAN2 the
  same way;
- the 128^3 hint: the port's ``hint_128`` against the JAX trainer's own
  condition and text (read from its source, evaluated on each config: no
  128^3 model is built), and the trainer printing it;
- the dispatcher of the attention kernels takes c = 128: on CPU tensors
  c = 128 passes the c check and fails on the device, c = 96 fails the
  c check; no kernel runs here.
"""

import ast
import inspect
import os

import numpy as np
import pytest
import torch

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.ops import cuda_attention
from gan3d_tpu_torch.train import trainer as port_trainer

from test_torch_layers import jax_reference_lowering  # noqa: F401,E402
from test_torch_step import jax_step, port_step_matches  # noqa: E402

torch.set_num_threads(1)

BIGGAN = dict(resolution=16, filterG=8, filterD=8, z_size=8, batch_size=2,
              iterD=2, biggan=True, compute_dtype="float32")


@pytest.mark.parametrize("kw", [dict(hinge=True),
                                dict(hinge=False, gp_weight=10.0)],
                         ids=["hinge", "wgan_gp"])
def test_split_step_matches_jax_split_steps(kw):
    """The port's step (iterD ``d_step`` calls and one ``g_step`` call)
    against the JAX split steps, the hinge step and the WGAN step with
    the gradient penalty."""
    kw = dict(BIGGAN, z_size=16, **kw)
    port_step_matches(Config(**kw), jax_step(kw, split=True))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _dataset(tmp_path, r=16):
    path = os.path.join(tmp_path, "train.npz")
    rng = np.random.default_rng(0)
    np.savez(path, X=np.tanh(rng.normal(size=(8, r, r, r))).astype(
        np.float32))
    return path


def _train(tmp_path, name, flags, niters):
    from gan3d_tpu_torch.cli.train import main

    main(["--platform=cpu", f"--data_path={_dataset(tmp_path)}",
          f"--log_dir={tmp_path / name}", "--resolution=16", "--z_size=8",
          "--batch_size=4", f"--niters={niters}", "--compute_dtype=float32",
          *flags])
    return torch.load(tmp_path / name / "models" / "checkpoint.pt",
                      weights_only=False)


@pytest.mark.parametrize("flags", [
    ["--biggan=True", "--hinge=True", "--filterG=8", "--filterD=8"],
    ["--stylegan2=True", "--filterG=16", "--filterD=16"]],
    ids=["biggan", "stylegan2"])
def test_cli_split_step_with_remat_trains_and_resumes(tmp_path, capsys,
                                                      flags):
    split = ["--fused_step=False", "--remat=True", "--remat_scope=stage"]
    got = _train(tmp_path, "split", flags + split, 2)
    out = capsys.readouterr().out
    assert "[1|2]" in out and "...Done (2 steps" in out
    assert "hint:" not in out
    want = _train(tmp_path, "fused", flags, 2)
    for net in ("modelG_state_dict", "modelD_state_dict"):
        assert list(got[net]) == list(want[net])
        for k, v in want[net].items():
            assert torch.equal(got[net][k], v), (net, k)
    assert got["lossG"] == want["lossG"] and got["lossD"] == want["lossD"]
    _train(tmp_path, "split", flags + split, 3)
    out = capsys.readouterr().out
    assert "starting from step 2" in out and "[2|3]" in out


def _jax_hint():
    """(the JAX trainer's 128^3 hint condition, compiled; its text), read
    from gan3d_tpu/train/trainer.py."""
    from gan3d_tpu.train import trainer as jax_trainer

    tree = ast.parse(inspect.getsource(jax_trainer))
    for node in ast.walk(tree):
        if not isinstance(node, ast.If):
            continue
        for call in ast.walk(ast.Module(body=node.body, type_ignores=[])):
            if (isinstance(call, ast.Call)
                    and getattr(call.func, "id", "") == "print"
                    and isinstance(call.args[0], ast.Constant)
                    and str(call.args[0].value).startswith("hint: at 128")):
                cond = compile(ast.Expression(node.test), "<jax hint>", "eval")
                return cond, call.args[0].value
    raise AssertionError("no 128^3 hint in gan3d_tpu/train/trainer.py")


@pytest.mark.parametrize("kw", [
    dict(resolution=128, biggan=True), dict(resolution=256),
    dict(resolution=128, remat=True), dict(resolution=64, biggan=True),
    dict(resolution=128, stylegan2=True), dict(resolution=128, stylegan=True),
    dict(resolution=128, dcgan=True), dict(resolution=128, hybrid=True)])
def test_hint_128_follows_the_jax_trainer(kw):
    from gan3d_tpu.config import Config as JConfig

    cond, text = _jax_hint()
    jcfg = JConfig(**kw)
    jax_prints = eval(cond, {}, {"cfg": jcfg, "self": type(
        "T", (), {"family": jcfg.family()})})
    assert port_trainer.hint_128(Config(**kw)) == (text if jax_prints
                                                   else None)


def test_trainer_prints_the_hint(tmp_path, capsys, monkeypatch):
    from gan3d_tpu_torch.data import open_dataset

    monkeypatch.setattr(port_trainer, "hint_128", lambda cfg: "hint: test")
    cfg = Config(resolution=16, filterG=8, filterD=8, z_size=8, batch_size=2,
                 platform="cpu", log_dir=str(tmp_path / "run"))
    port_trainer.Trainer(open_dataset(_dataset(tmp_path)), cfg)
    assert "hint: test\n" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the attention kernels' dispatcher at c = 128
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c,error", [(128, "not a CUDA device"),
                                     (96, "c=96 not in")])
def test_check_inputs_takes_c_128(c, error):
    for dt in (torch.float32, torch.bfloat16):
        q = torch.zeros((2, 64, c), dtype=dt)
        k = torch.zeros((2, 8, c), dtype=dt)
        with pytest.raises(ValueError, match=error):
            cuda_attention.check_inputs(q, k, k)


@pytest.mark.parametrize("n,L,m,c,want", [(16, 4096, 512, 128, 2),
                                          (16, 32768, 4096, 64, 1),
                                          (16, 4096, 512, 64, 3),
                                          (2, 1000, 125, 128, 16)])
def test_dkdv_split_counts_the_column_halves(n, L, m, c, want):
    """At c = 128 the bf16 dk/dv pass runs two column halves a key block,
    so it needs fewer parts to cover the card twice: 2 at the 128^3 D
    placement (256 blocks -> 512), where c = 64 takes 3."""
    parts = cuda_attention.dkdv_split(n, L, m, c)
    assert parts == want
    halves = 2 if c > cuda_attention.WIDE_C else 1
    assert (n * -(-m // 64) * halves * parts >= 2 * cuda_attention.SMS
            or parts == -(-L // 64))

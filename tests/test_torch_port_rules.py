"""Rules the port keeps, and its train CLI end to end on the CPU.

- No module of gan3d_tpu_torch, and not chip_smoke.py, imports JAX or
  anything of gan3d_tpu (checked in a fresh interpreter); scipy is
  imported only under gan3d_tpu_torch/eval/.
- With the default platform ("" = the CUDA card) the trainer raises when
  there is no CUDA device; it never carries on on the CPU.
- Options whose code paths are not ported raise instead of being ignored;
  on the card, so does the gradient penalty for a D with attention.
- A 2-step CPU run of ``python -m gan3d_tpu_torch.cli.train`` at 16^3,
  filters 8 writes params.json, a checkpoint and a PNG, and a re-run with
  more steps resumes ("starting from step 2"), for the BigGAN flagship's
  flags and for ``--dcgan=True --sagan=True``; with ``--wide_conv=on
  --fast_dw=on`` at filters 32 it trains and resumes through the k3 conv
  routes, and a conv mode outside off|auto|on raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.models import build_models
from gan3d_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import gan3d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gan3d_tpu_torch.__path__,
                                               "gan3d_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import torch.nn.functional  # imported inside chip_smoke's phases
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "gan3d_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_no_jax_or_reference_package_imported():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "gan3d_tpu_torch.train.trainer" in res["modules"]
    assert "gan3d_tpu_torch.ops.cuda_attention" in res["modules"]
    assert "gan3d_tpu_torch.ops.cuda_conv" in res["modules"]
    assert "gan3d_tpu_torch.ops.toeplitz_conv" in res["modules"]
    assert "gan3d_tpu_torch.probes.mosaic_ladder" in res["modules"]
    assert "gan3d_tpu_torch.models.stylegan.loss" in res["modules"]
    assert "gan3d_tpu_torch.eval.metrics" in res["modules"]
    assert "gan3d_tpu_torch.cli.eval" in res["modules"]
    assert "gan3d_tpu_torch.cli.tournament" in res["modules"]
    assert "gan3d_tpu_torch.cli.eval_metrics" in res["modules"]
    assert res["bad"] == []


def _imported_roots(path):
    """The top-level packages a source file imports (at any depth)."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_scipy_only_in_eval():
    """The port imports torch and numpy; scipy (the Fréchet distance's
    sqrtm) only in its evaluation package, gan3d_tpu_torch/eval/."""
    pkg = os.path.join(REPO, "gan3d_tpu_torch")
    users = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                if "scipy" in _imported_roots(path):
                    users.append(os.path.relpath(path, pkg))
    assert users and all(u.startswith("eval" + os.sep) for u in users), users
    assert "scipy" not in _imported_roots(os.path.join(REPO,
                                                       "chip_smoke.py"))


def _dataset(tmp_path, n=8, r=16):
    path = os.path.join(tmp_path, "train.npz")
    rng = np.random.default_rng(0)
    np.savez(path, X=np.tanh(rng.normal(size=(n, r, r, r))).astype(np.float32))
    return path


def test_default_platform_raises_without_cuda(tmp_path, monkeypatch):
    from gan3d_tpu_torch.data import open_dataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(resolution=16, filterG=8, filterD=8, z_size=8, batch_size=2,
                 log_dir=str(tmp_path / "run"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(open_dataset(_dataset(tmp_path)), cfg)


@pytest.mark.parametrize("kw", [dict(stylegan=True, remat=True),
                                dict(stylegan2=True, remat=True),
                                dict(remat=True), dict(track_energy=True),
                                dict(spatial_devices=2), dict(model_devices=2),
                                dict(fused_step=False),
                                dict(param_dtype="bfloat16")])
def test_unported_options_raise(tmp_path, kw):
    from gan3d_tpu_torch.data import open_dataset

    cfg = Config(resolution=16, filterG=8, filterD=8, z_size=8, batch_size=2,
                 platform="cpu", log_dir=str(tmp_path / "run"), **kw)
    with pytest.raises(NotImplementedError):
        Trainer(open_dataset(_dataset(tmp_path)), cfg)


@pytest.mark.parametrize("kw", [dict(dcgan=True, sagan=True),
                                dict(biggan=True, resolution=32),
                                dict(hybrid=True, sagan=True)])
def test_gradient_penalty_with_attention_in_d_raises_on_the_card(
        tmp_path, monkeypatch, kw):
    """gp_weight > 0 differentiates D twice; the attention kernels' backward
    is first-order, so on the card the trainer refuses a D with attention
    (the device is stubbed: the check runs before anything moves to it)."""
    from gan3d_tpu_torch.data import open_dataset
    from gan3d_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "resolve_device",
                        lambda platform: torch.device("cuda"))
    monkeypatch.setattr(trainer, "configure_precision", lambda device: None)
    kw = {"resolution": 16, **kw}
    cfg = Config(filterG=8, filterD=8, z_size=8, batch_size=2,
                 gp_weight=10.0, log_dir=str(tmp_path / "run"), **kw)
    with pytest.raises(NotImplementedError, match="first-order"):
        Trainer(open_dataset(_dataset(tmp_path)), cfg)


@pytest.mark.parametrize("kw", [dict(wide_conv="yes"), dict(fast_dw="fast")])
def test_conv_modes_outside_off_auto_on_raise(tmp_path, kw):
    from gan3d_tpu_torch.data import open_dataset
    from gan3d_tpu_torch.ops import conv3d

    cfg = Config(resolution=16, filterG=8, filterD=8, z_size=8, batch_size=2,
                 platform="cpu", log_dir=str(tmp_path / "run"), **kw)
    try:
        with pytest.raises(ValueError, match="not in"):
            Trainer(open_dataset(_dataset(tmp_path)), cfg)
    finally:
        conv3d.set_wide_conv_mode("auto")
        conv3d.set_fast_dw_mode("auto")


@pytest.mark.parametrize("platform", ["cuda", "tpu", "gpu"])
def test_only_the_two_platform_spellings_parse(platform):
    from gan3d_tpu_torch.utils.platform import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="not in"):
        resolve_device(platform)


def test_loader_epochs_are_whole_shuffled_batches(tmp_path):
    """Each epoch of 10 samples in batches of 4 yields 2 full batches of
    distinct samples; a dataset smaller than one batch raises."""
    from gan3d_tpu_torch.data import Loader, open_dataset

    ds = open_dataset(_dataset(tmp_path, n=10, r=4))
    loader = Loader(ds, 4, seed=0, num_workers=1)
    batches = loader.infinite()
    try:
        for _ in range(3):
            a, b = next(batches), next(batches)
            assert a.shape == b.shape == (4, 4, 4, 4) and a.dtype == np.float32
            rows = {r.tobytes() for r in np.concatenate([a, b])}
            assert len(rows) == 8
            assert rows <= {ds[i].tobytes() for i in range(10)}
    finally:
        batches.close()
        loader.close()
    with pytest.raises(ValueError, match="no batch"):
        Loader(ds, 11)


def test_init_is_seeded():
    cfg = Config(resolution=16, filterG=8, filterD=8, z_size=8, seed=3)
    a, b = build_models(cfg)[0].state_dict(), build_models(cfg)[0].state_dict()
    c = build_models(cfg.replace(seed=4))[0].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["linear.bias"], c["linear.bias"])


def test_cli_train_and_resume_on_cpu(tmp_path, capsys):
    from gan3d_tpu_torch.cli.train import main

    data = _dataset(tmp_path)
    log_dir = str(tmp_path / "run")
    argv = [f"--data_path={data}", f"--log_dir={log_dir}", "--platform=cpu",
            "--biggan=True", "--hinge=True", "--resolution=16",
            "--filterG=8", "--filterD=8", "--z_size=8", "--batch_size=2",
            "--steps_per_log=1", "--data_loader_workers=1"]
    main(argv + ["--niters=2"])
    out = capsys.readouterr().out
    assert "[0|2]\tD(x): " in out and "\tFID nan" in out
    assert "...Done (2 steps in " in out and "vol/s)" in out
    assert os.path.isfile(os.path.join(log_dir, "params.json"))
    assert os.path.isfile(os.path.join(log_dir, "models", "checkpoint.pt"))
    assert os.path.isfile(os.path.join(log_dir, "images", "1.png"))
    with open(os.path.join(log_dir, "params.json")) as f:
        assert json.load(f)["biggan"] is True
    ckpt = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                      weights_only=True)
    assert ckpt["step"] == 2 and len(ckpt["lossG"]) == 2

    main(argv + ["--niters=3"])
    out = capsys.readouterr().out
    assert "starting from step 2" in out
    assert "[2|3]" in out and "...Done (1 steps in " in out


def test_cli_train_and_resume_dcgan_sagan_on_cpu(tmp_path, capsys):
    """--dcgan=True --sagan=True at 16^3: the DCGAN G and the SN D with
    attention at 8^3 train, log, write a [2, 1, 16, 16, 16] sample grid and
    a reference-layout checkpoint, and resume."""
    from gan3d_tpu_torch.cli.train import main

    data = _dataset(tmp_path)
    log_dir = str(tmp_path / "run")
    argv = [f"--data_path={data}", f"--log_dir={log_dir}", "--platform=cpu",
            "--dcgan=True", "--sagan=True", "--resolution=16",
            "--filterG=8", "--filterD=8", "--z_size=8", "--batch_size=2",
            "--steps_per_log=1", "--data_loader_workers=1"]
    main(argv + ["--niters=2"])
    out = capsys.readouterr().out
    assert "[1|2]\tD(x): " in out and "...Done (2 steps in " in out
    assert os.path.isfile(os.path.join(log_dir, "images", "1.png"))
    ckpt = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                      weights_only=True)
    assert "main.0.parametrizations.weight.original" in \
        ckpt["modelD_state_dict"]
    assert ckpt["modelG_state_dict"]["main.0.weight"].shape == (8, 16, 4, 4,
                                                                4)
    main(argv + ["--niters=3"])
    out = capsys.readouterr().out
    assert "starting from step 2" in out and "[2|3]" in out
    ckpt = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                      weights_only=True)
    assert ckpt["step"] == 3 and all(np.isfinite(ckpt["lossG"]))


def test_cli_train_and_resume_with_conv_kernels_on_cpu(tmp_path, capsys,
                                                       monkeypatch):
    """--wide_conv=on --fast_dw=on: every eligible conv's forward, dx and
    dW go through the wide-N conv and dW routes (their plain versions on
    the CPU), and the run resumes."""
    from gan3d_tpu_torch.cli.train import main
    from gan3d_tpu_torch.ops import conv3d, cuda_conv

    calls = {"wide": 0, "dw": 0}

    def counted(name, fn):
        def run(*a):
            calls[name] += 1
            return fn(*a)
        return run

    monkeypatch.setattr(cuda_conv, "_wide", counted("wide", cuda_conv._wide))
    monkeypatch.setattr(cuda_conv, "_dw", counted("dw", cuda_conv._dw))
    data = _dataset(tmp_path)
    log_dir = str(tmp_path / "run")
    argv = [f"--data_path={data}", f"--log_dir={log_dir}", "--platform=cpu",
            "--biggan=True", "--hinge=True", "--resolution=16",
            "--filterG=32", "--filterD=32", "--z_size=8", "--batch_size=2",
            "--data_loader_workers=1", "--wide_conv=on", "--fast_dw=on"]
    try:
        main(argv + ["--niters=2"])
        assert calls["wide"] > 0 and calls["dw"] > 0
        assert conv3d.wide_conv_enabled() and conv3d.fast_dw_enabled()
        out = capsys.readouterr().out
        assert "...Done (2 steps in " in out
        main(argv + ["--niters=3"])
        out = capsys.readouterr().out
        assert "starting from step 2" in out and "[2|3]" in out
    finally:
        conv3d.set_wide_conv_mode("auto")
        conv3d.set_fast_dw_mode("auto")
    ckpt = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                      weights_only=True)
    with open(os.path.join(log_dir, "params.json")) as f:
        params = json.load(f)
    assert params["wide_conv"] == params["fast_dw"] == "on"
    assert ckpt["step"] == 3 and len(ckpt["lossG"]) == 3
    assert all(np.isfinite(ckpt["lossG"]))

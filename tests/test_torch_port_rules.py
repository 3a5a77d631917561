"""Rules the port keeps, and its train CLI end to end on the CPU.

- No module of gan3d_tpu_torch, and not chip_smoke.py, imports JAX or
  anything of gan3d_tpu (checked in a fresh interpreter).
- With the default platform ("" = the CUDA card) the trainer raises when
  there is no CUDA device; it never carries on on the CPU.
- Options whose code paths are not ported raise instead of being ignored.
- A 2-step CPU run of ``python -m gan3d_tpu_torch.cli.train`` at 16^3,
  filters 8 writes params.json, a checkpoint and a PNG, and a re-run with
  more steps resumes ("starting from step 2").
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
    assert res["bad"] == []


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


@pytest.mark.parametrize("kw", [dict(dcgan=True), dict(stylegan2=True),
                                dict(remat=True), dict(fid_in_loop=True),
                                dict(spatial_devices=2), dict(async_log=True),
                                dict(fused_step=False),
                                dict(param_dtype="bfloat16")])
def test_unported_options_raise(tmp_path, kw):
    from gan3d_tpu_torch.data import open_dataset

    cfg = Config(resolution=16, filterG=8, filterD=8, z_size=8, batch_size=2,
                 platform="cpu", log_dir=str(tmp_path / "run"), **kw)
    with pytest.raises(NotImplementedError):
        Trainer(open_dataset(_dataset(tmp_path)), cfg)


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

"""The port's trainer profiler (gan3d_tpu_torch/utils/profiling.py).

StepProfiler alone writes one Chrome trace of its window, and nothing with
an empty ``profile_dir``; a tiny CPU train run through the CLI with
``--profile_dir`` passes the trainer's hook and writes the trace of steps
5-9.
"""

import json
import os

import numpy as np
import torch

from gan3d_tpu_torch.utils.profiling import (PROFILE_START, PROFILE_STEPS,
                                             StepProfiler)

torch.set_num_threads(1)


def _drive(prof, steps):
    x = torch.ones(8, 8)
    for i in range(steps):
        prof.step(i)
        x = torch.mm(x, x).tanh()
    prof.close()


def test_step_profiler_writes_its_window(tmp_path):
    prof = StepProfiler(str(tmp_path / "trace"), start=1, num_steps=2)
    _drive(prof, 5)
    assert prof.path == str(tmp_path / "trace" / "trace_steps_1-2.json")
    assert os.listdir(tmp_path / "trace") == ["trace_steps_1-2.json"]
    with open(prof.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_step_profiler_close_ends_an_open_window(tmp_path):
    prof = StepProfiler(str(tmp_path), start=1, num_steps=5)
    _drive(prof, 3)
    assert os.listdir(tmp_path) == ["trace_steps_1-2.json"]


def test_step_profiler_without_a_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    prof = StepProfiler("", start=1, num_steps=2)
    _drive(prof, 5)
    assert prof.path is None
    assert os.listdir(tmp_path) == []


def test_cli_train_with_profile_dir_on_cpu(tmp_path, capsys):
    """16^3, filters 8: the window closes at the first step past it."""
    from gan3d_tpu_torch.cli.train import main

    data = os.path.join(tmp_path, "train.npz")
    rng = np.random.default_rng(0)
    np.savez(data, X=np.tanh(rng.normal(size=(8, 16, 16, 16))).astype(
        np.float32))
    trace = tmp_path / "trace"
    niters = PROFILE_START + PROFILE_STEPS + 1
    main([f"--data_path={data}", f"--log_dir={tmp_path / 'run'}",
          "--platform=cpu", "--biggan=True", "--hinge=True",
          "--resolution=16", "--filterG=8", "--filterD=8", "--z_size=8",
          "--batch_size=2", "--data_loader_workers=1", f"--niters={niters}",
          f"--profile_dir={trace}"])
    assert f"...Done ({niters} steps in " in capsys.readouterr().out
    last = PROFILE_START + PROFILE_STEPS - 1
    assert os.listdir(trace) == [f"trace_steps_{PROFILE_START}-{last}.json"]

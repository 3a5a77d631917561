"""The port's in-loop FID and deferred logging (gan3d_tpu_torch/train/
trainer.py) against the JAX trainer's (gan3d_tpu/train/trainer.py).

- Fault C1: with an Inception weights file in the run's log dir and
  ``fid_in_loop`` unset, a 2-step CPU run builds the slice FID from that
  file and logs a finite FID (the extractor is a cheap recording stub: a
  real Inception forward at 299^2 is tens of seconds on a CPU).
"""

import contextlib
import io
import math
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

INCEPTION_FILE = "pt_inception-2015-12-05-6726825d.pth"
R = 16
FLAGS = ["--biggan=True", "--hinge=True", f"--resolution={R}",
         "--filterG=8", "--filterD=8", "--z_size=8", "--batch_size=2",
         "--compute_dtype=float32", "--data_loader_workers=1"]


def _dataset(path, n=8):
    rng = np.random.default_rng(0)
    np.savez(path, X=np.tanh(rng.normal(size=(n, R, R, R))).astype(
        np.float32))
    return str(path)


class StubInception:
    """Stands in for the port's InceptionV3Features: 8 pixel values of each
    slice's first channel as its features; records the weights path."""

    built = []

    def __init__(self, weights_path=None, device=torch.device("cpu")):
        StubInception.built.append(weights_path)

    def __call__(self, x):
        return x.float()[:, 0, :2, :4].reshape(x.shape[0], 8)


def logged_fids(out):
    return [float(v) for v in re.findall(r"\tFID (\S+)", out)]


def test_c1_weights_in_the_log_dir_give_a_finite_fid(tmp_path, monkeypatch,
                                                      capsys):
    from gan3d_tpu_torch.cli.train import main
    from gan3d_tpu_torch.eval import inception

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(inception, "InceptionV3Features", StubInception)
    StubInception.built = []
    log_dir = tmp_path / "run"
    os.makedirs(log_dir)
    weights = str(log_dir / INCEPTION_FILE)
    torch.save({}, weights)
    main([f"--data_path={_dataset(tmp_path / 'train.npz')}",
          f"--log_dir={log_dir}", "--platform=cpu", "--niters=2",
          "--steps_per_log=1", *FLAGS])
    fids = logged_fids(capsys.readouterr().out)
    assert StubInception.built == [weights]
    assert len(fids) == 3 and all(math.isfinite(f) for f in fids), fids


# ---------------------------------------------------------------------------
# the decision table against the JAX trainer's
# ---------------------------------------------------------------------------
class StubSliceFID:
    """Stands in for SliceFID in both packages: records the weights path
    it was built with (None: the random stand-in) and raises on a file
    that holds b"bad"."""

    built = []

    def __init__(self, extractor=None, weights_path=None, batch_size=128,
                 device=None):
        if weights_path:
            with open(weights_path, "rb") as f:
                if f.read() == b"bad":
                    raise RuntimeError("cannot load " + weights_path)
        StubSliceFID.built.append(weights_path)

    def axial(self, fake, real):
        return 1.5


# case: (fid_in_loop, where the weights file lies: None, "cwd", "log_dir"
# or "named" (inception_weights), its content)
CASES = {
    "off": (False, "log_dir", b"ok"),
    "none_no_weights": (None, None, b""),
    "none_weights_in_cwd": (None, "cwd", b"ok"),
    "none_weights_in_log_dir": (None, "log_dir", b"ok"),
    "inception_weights_set": (None, "named", b"ok"),
    "weights_fail_to_load": (None, "log_dir", b"bad"),
    "true_no_weights": (True, None, b""),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_inloop_fid_decision_matches_jax(case, tmp_path, monkeypatch,
                                         capsys):
    from types import SimpleNamespace

    from gan3d_tpu import config as jconfig
    from gan3d_tpu.eval import slice_fid as jslice_fid
    from gan3d_tpu.train.trainer import Trainer as JTrainer
    from gan3d_tpu_torch.config import Config
    from gan3d_tpu_torch.eval import slice_fid
    from gan3d_tpu_torch.train.trainer import Trainer

    mode, where, content = CASES[case]
    cwd, log_dir = tmp_path / "cwd", tmp_path / "run"
    os.makedirs(cwd)
    os.makedirs(log_dir)
    monkeypatch.chdir(cwd)
    named = ""
    if where is not None:
        path = {"cwd": cwd / INCEPTION_FILE,
                "log_dir": log_dir / INCEPTION_FILE,
                "named": tmp_path / "weights.pth"}[where]
        path.write_bytes(content)
        named = str(path) if where == "named" else ""
    monkeypatch.setattr(jslice_fid, "SliceFID", StubSliceFID)
    monkeypatch.setattr(slice_fid, "SliceFID", StubSliceFID)
    got = {}
    for pkg, make in (("jax", lambda: SimpleNamespace(
                           cfg=jconfig.Config(fid_in_loop=mode,
                                              inception_weights=named),
                           log_dir=str(log_dir))),
                      ("torch", lambda: SimpleNamespace(
                           cfg=Config(fid_in_loop=mode,
                                      inception_weights=named),
                           log_dir=str(log_dir),
                           device=torch.device("cpu")))):
        StubSliceFID.built = []
        self = make()
        cls = JTrainer if pkg == "jax" else Trainer
        fn = cls._make_inloop_fid(self)
        got[pkg] = (list(StubSliceFID.built), self._fid_active,
                    math.isnan(fn(None, None)), capsys.readouterr().out)
    assert got["torch"] == got["jax"]
    built, active, nan, out = got["torch"]
    want_active = case in ("none_weights_in_cwd", "none_weights_in_log_dir",
                           "inception_weights_set", "true_no_weights")
    assert active == want_active and nan == (not want_active)
    if case == "true_no_weights":
        assert built == [None]
    elif want_active:
        assert built == [str(path)]
    if case == "weights_fail_to_load":
        assert "in-loop FID disabled: cannot load" in out
    if case == "none_no_weights":
        assert "no Inception weights found" in out


# ---------------------------------------------------------------------------
# the logged value, and the deferred log
# ---------------------------------------------------------------------------
def test_logged_fid_is_the_slice_fid_of_the_step_fake_and_reals(
        tmp_path, monkeypatch):
    """fid_in_loop=True, 2 steps: each logged FID is a fresh stand-in
    SliceFID's axial FID of the G update's fake [B, 1, R, R, R] and the
    last D sub-batch [B, R, R, R] (f32, drawn from the data set)."""
    from gan3d_tpu_torch.config import config_from_args
    from gan3d_tpu_torch.data import open_dataset
    from gan3d_tpu_torch.eval import slice_fid
    from gan3d_tpu_torch.train.trainer import Trainer

    monkeypatch.chdir(tmp_path)
    seen = []
    axial = slice_fid.SliceFID.axial

    def recording(self, fake, real):
        seen.append((fake.clone(), real.clone()))
        return axial(self, fake, real)

    monkeypatch.setattr(slice_fid.SliceFID, "axial", recording)
    data = _dataset(tmp_path / "train.npz")
    cfg = config_from_args([f"--data_path={data}",
                            f"--log_dir={tmp_path / 'run'}",
                            "--platform=cpu", "--niters=2",
                            "--steps_per_log=1", "--fid_in_loop=True",
                            *FLAGS])
    trainer = Trainer(open_dataset(data), cfg)
    trainer.train()
    assert len(trainer.fid) == len(seen) == 3
    rows = {r.tobytes() for r in open_dataset(data).data.clip(-1, 1)}
    fresh = slice_fid.SliceFID()
    for got, (fake, real) in zip(trainer.fid, seen):
        assert fake.shape == (2, 1, R, R, R) and real.shape == (2, R, R, R)
        assert real.dtype == torch.float32
        assert {r.numpy().tobytes() for r in real} <= rows
        np.testing.assert_allclose(got, axial(fresh, fake, real), rtol=1e-6)
        assert math.isfinite(got)


def test_axial_fid_matches_jax_with_the_stand_in_weights():
    """The port's SliceFID.axial and the JAX SliceFID.axial with the same
    stand-in extractor weights (RandomConvFeatures2D's tree from
    ``jax.eval_shape`` of its init, filled from numpy: the init's PRNG
    compiles cost seconds and tests/test_torch_eval.py checks the init's
    own weights), on 24 volumes at 16^3 (384 slices, so both covariances
    of the 256 features have full rank): within 1e-4 relative."""
    import jax
    import jax.numpy as jnp

    from gan3d_tpu.eval import slice_fid as jslice_fid
    from gan3d_tpu_torch.eval import slice_fid

    rng = np.random.default_rng(4)
    jm = jslice_fid.RandomConvFeatures2D()
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, 8, 8, 3)))
    v = jax.tree.map(lambda s: (rng.normal(size=s.shape) * 0.2).astype(
        np.float32), shapes)
    p = v["params"]
    jitted = jax.jit(jm.apply)
    ref = jslice_fid.SliceFID(extractor=lambda x: jitted(v, x))
    ours = slice_fid.SliceFID()
    with torch.no_grad():
        for i, conv in enumerate(ours.model.convs):
            conv.weight.copy_(torch.tensor(
                p[f"Conv_{i}"]["kernel"].transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.tensor(p[f"Conv_{i}"]["bias"]))
        ours.model.fc.weight.copy_(torch.tensor(p["Dense_0"]["kernel"].T))
        ours.model.fc.bias.copy_(torch.tensor(p["Dense_0"]["bias"]))
    fake = np.tanh(rng.normal(size=(24, 1, R, R, R))).astype(np.float32)
    real = np.tanh(rng.normal(size=(24, R, R, R)) * 0.5).astype(np.float32)
    got = ours.axial(torch.from_numpy(fake), torch.from_numpy(real))
    want = ref.axial(jnp.asarray(np.moveaxis(fake, 1, -1)),
                     jnp.asarray(real[..., None]))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _train_log(tmp_path, name, extra):
    from gan3d_tpu_torch.cli.train import main

    log_dir = tmp_path / name
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main([f"--data_path={tmp_path / 'train.npz'}", f"--log_dir={log_dir}",
              "--platform=cpu", "--niters=4", "--steps_per_log=2",
              "--steps_per_ckpt=2", "--fid_in_loop=True", *FLAGS, *extra])
    buf = [ln for ln in out.getvalue().splitlines() if ln.startswith("[")]
    ckpt = torch.load(log_dir / "models" / "checkpoint.pt",
                      weights_only=True)
    return buf, {k: ckpt[k] for k in ("lossG", "lossD", "fid")}


def test_async_log_prints_and_saves_what_the_eager_log_does(tmp_path,
                                                           monkeypatch):
    """4 steps, steps_per_log=2, a checkpoint every 2 steps, the stand-in
    FID: async_log=True prints the same lines ([0|4], [2|4], [3|4]) and
    saves the same loss and FID histories as async_log=False."""
    monkeypatch.chdir(tmp_path)
    _dataset(tmp_path / "train.npz")
    eager = _train_log(tmp_path, "eager", ["--async_log=False"])
    deferred = _train_log(tmp_path, "deferred", ["--async_log=True"])
    assert [ln.split("\t")[0] for ln in eager[0]] == ["[0|4]", "[2|4]",
                                                      "[3|4]"]
    assert deferred[0] == eager[0]
    assert deferred[1] == eager[1]
    # one checkpoint step (2): the mean of steps 0 and 2's FIDs
    assert len(eager[1]["fid"]) == 1 and math.isfinite(eager[1]["fid"][0])

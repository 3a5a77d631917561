"""The port's remaining evaluation CLIs (gan3d_tpu_torch/cli/tournament.py,
eval_metrics.py, export_torch.py, real_ims.py, make_dir_dataset.py, and
eval/export.py) and the data layer's options against the JAX package's.

- tournament: ``get_decision_bound`` (all batches, and the last batch
  with ``compat_last_batch``) and ``play_round`` against the JAX functions
  on the same port runs (the JAX ``load_run`` reads them), the noise the
  JAX side draws recorded and replayed through the port's ``_noise``: the
  bound within 1e-4 of the largest score, equal win rates but where a
  score lies within 1e-4 of the bound; the CLI on two runs, one with
  attention in D, on the CPU; without ``--platform=cpu`` it raises, as it
  does for ``--num_devices=2``;
- calibration: ``data_vs_data`` against the JAX ``calibrate`` on the same
  batches with the same small extractors (1e-4 relative); the randn
  controls separate; the CLI's data path, warning and ``size 32`` branch
  (extractors stubbed: the default ResNet-50's 2048 features cost a ~20 s
  ``sqrtm`` a distance on a CPU);
- export: on a BigGAN and a StyleGAN2 run, ``params.pkl`` against the JAX
  ``Config.to_namespace``, the checkpoint's keys, the optimizer states
  against the JAX ``_empty_adam_state``, ``torch.optim.Adam`` loading
  them, and the JAX ``load_run`` of the exported dir sampling like the
  port's ``load_run`` of the source dir (1e-4 of the largest value; the
  StyleGAN2 per-layer noise is zero on both sides, since the packages
  draw it from different generators);
- ``real_ims`` and ``make_dir_dataset``: the same files as the JAX CLIs';
  ``compat_len``; ``Loader``'s epochs with ``shuffle`` and ``drop_last``
  against the JAX loader's.

Tiny f32 port runs (16^3, filters 8-16, 2 steps) are built and exported
once. The JAX side's ``jax.random`` draws come from numpy where the test
records or ignores them (``numpy_draws``): the threefry compiles would
cost seconds, and the port draws from torch generators anyway.
"""

import os
import pickle
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

R = 16
RUNS = {
    "biggan": ["--biggan=True", "--hinge=True", "--filterG=8", "--filterD=8",
               "--batch_size=2"],
    "dcgan_sagan": ["--dcgan=True", "--sagan=True", "--hinge=True",
                    "--filterG=8", "--filterD=8", "--batch_size=2"],
    "stylegan2": ["--stylegan2=True", "--filterG=16", "--filterD=16",
                  "--batch_size=4"],
}


def vols(n, r, seed):
    rng = np.random.default_rng(seed)
    return np.tanh(rng.normal(size=(n, r, r, r))).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 2-step f32 port run per entry of RUNS (dirs ``<name>0``, the CLIs'
    ``path + seed`` naming) and a 10-volume 16^3 test set."""
    from gan3d_tpu_torch.cli.train import main

    root = tmp_path_factory.mktemp("eval_cli_runs")
    data = str(root / "test.npz")
    np.savez(data, X=vols(10, R, 0))
    out = {"data": data}
    for name, flags in RUNS.items():
        out[name] = str(root / name)
        main([f"--data_path={data}", f"--log_dir={out[name]}0",
              "--platform=cpu", f"--resolution={R}", "--z_size=8",
              "--niters=2", "--data_loader_workers=1",
              "--compute_dtype=float32", *flags])
    return out


@pytest.fixture(scope="module")
def exported(runs):
    """The BigGAN and StyleGAN2 runs exported by the port's CLI:
    {name: (exported dir, checkpoint path)}."""
    from gan3d_tpu_torch.cli import export_torch

    out = {}
    for name in ("biggan", "stylegan2"):
        d = runs[name] + "_exported"
        out[name] = (d, export_torch.main(["--log_dir", runs[name] + "0",
                                           "--out", d, "--platform=cpu"]))
    return out


@pytest.fixture
def numpy_draws(monkeypatch):
    """The JAX tournament and calibration modules' jax.random.key / split /
    normal / uniform from numpy (a key is an int)."""
    from types import SimpleNamespace

    from gan3d_tpu.cli import eval_metrics, tournament

    def draw(name):
        def fn(key, shape, dtype=np.float32):
            rng = np.random.default_rng(key)
            return jnp.asarray(getattr(rng, name)(size=shape).astype(dtype))
        return fn

    shim = SimpleNamespace(random=SimpleNamespace(
        key=int, split=lambda key, num=2: tuple(key * 7 + i + 1
                                                for i in range(num)),
        normal=draw("standard_normal"), uniform=draw("random")))
    for module in (eval_metrics, tournament):
        monkeypatch.setattr(module, "jax", shim)
    return shim.random


# ---------------------------------------------------------------------------
# tournament
# ---------------------------------------------------------------------------
def recording(fn, into):
    def call(z):
        into.append(np.array(z))
        return fn(z)
    return call


@pytest.fixture(scope="module")
def jax_judge(runs, exported):
    """The JAX score and samplers of the judge (dcgan_sagan: attention in
    D) and the rival (biggan, read from its exported dir), loaded once
    (each jit compiles once a batch shape)."""
    from gan3d_tpu.eval.load import load_run, make_discriminator_fn, \
        make_sampler

    cfg, G, D, gv, dv = load_run(runs["dcgan_sagan"] + "0")
    rcfg, rG, _, rgv, _ = load_run(exported["biggan"][0])
    return (make_discriminator_fn(cfg, D, dv), make_sampler(cfg, G, gv),
            make_sampler(rcfg, rG, rgv), cfg.z_size)


def replay(monkeypatch, noises):
    from gan3d_tpu_torch.cli import tournament as T

    queue = [torch.from_numpy(z) for z in noises]

    def _noise(gen, n, z_size):
        z = queue.pop(0)
        assert z.shape == (n, z_size)
        return z

    monkeypatch.setattr(T, "_noise", _noise)
    return queue


def port_judge(runs):
    from gan3d_tpu_torch.eval.load import load_run, make_discriminator_fn, \
        make_sampler

    cfg, G, D = load_run(runs["dcgan_sagan"] + "0")
    _, rG, _ = load_run(runs["biggan"] + "0")
    return make_discriminator_fn(cfg, D), make_sampler(cfg, G), \
        make_sampler(cfg, rG)


def test_port_runs_have_attention_in_the_judge_d(runs):
    from gan3d_tpu_torch.eval.load import load_run
    from gan3d_tpu_torch.nn.attention import SelfAttention3d

    _, _, D = load_run(runs["dcgan_sagan"] + "0")
    assert any(isinstance(m, SelfAttention3d) for m in D.modules())


@pytest.mark.parametrize("compat", [False, True])
def test_decision_bound_matches_jax(runs, jax_judge, monkeypatch,
                                    numpy_draws, compat):
    from gan3d_tpu.cli import tournament as JT
    from gan3d_tpu_torch.cli import tournament as T
    from gan3d_tpu_torch.data import Loader, open_dataset

    jscore, jsample, _, z_size = jax_judge
    # 10 volumes in batches of 4: the last batch is partial
    batches = list(Loader(open_dataset(runs["data"]), 4, seed=1,
                          drop_last=False))
    assert [b.shape[0] for b in batches] == [4, 4, 2]
    noises, scores = [], []
    want = JT.get_decision_bound(lambda x: scores.append(np.asarray(
        jscore(x))) or scores[-1], recording(jsample, noises), z_size,
        batches, 0, compat)
    queue = replay(monkeypatch, noises)
    score, sample, _ = port_judge(runs)
    got = T.get_decision_bound(score, sample, z_size, batches,
                               torch.Generator(), compat)
    assert not queue
    scale = max(np.abs(s).max() for s in scores)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_play_round_matches_jax(runs, jax_judge, monkeypatch, numpy_draws):
    from gan3d_tpu.cli import tournament as JT
    from gan3d_tpu_torch.cli import tournament as T

    jscore, _, jrival, z_size = jax_judge
    score, _, rival = port_judge(runs)
    bound = float(np.median(np.asarray(jscore(jrival(numpy_draws.normal(
        5, (4, z_size)))))))
    noises = []
    want = JT.play_round(jscore, recording(jrival, noises), z_size, bound,
                         4, 1)
    queue = replay(monkeypatch, noises)
    seen = []
    got = T.play_round(lambda x: seen.append(score(x)) or seen[-1], rival,
                       z_size, bound, 4, torch.Generator())
    assert not queue and len(seen) == 2
    fakes = torch.cat(seen).numpy().ravel()
    near = np.abs(fakes - bound) <= 1e-4 * np.abs(fakes).max()
    assert got == want or near.any(), (got, want, fakes, bound)
    assert 0.0 <= got <= 1.0


def test_tournament_cli_on_cpu(runs, capsys, monkeypatch):
    from gan3d_tpu_torch.cli import tournament

    means = tournament.main(["--data_path", runs["data"], "--batch_size=4",
                             "--n_seeds=1", "-l", runs["dcgan_sagan"], "-l",
                             runs["biggan"], "--platform=cpu"])
    out = capsys.readouterr().out
    assert "------------- Tournament Results -------------" in out
    rates = [float(m) for m in re.findall(r"Win Rate of ([0-9.]+)", out)]
    assert len(rates) == 2 and all(0.0 <= r <= 1.0 for r in rates)
    assert sorted(means) == sorted([runs["dcgan_sagan"], runs["biggan"]])
    assert all(0.0 <= v <= 1.0 for v in means.values())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tournament.main(["--data_path", runs["data"], "-l", runs["biggan"]])
    # more cards than are visible (a stubbed one-card host) raise before
    # anything runs; the data-parallel tournament: test_torch_dp_eval.py
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 are visible"):
        tournament.main(["--data_path", runs["data"], "-l", runs["biggan"],
                         "--num_devices=2"])


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
def port_extractors():
    """8 octant means of a volume; 4 quadrant means of a slice's first
    channel (fewer features than the samples: full-rank covariances)."""
    from gan3d_tpu_torch.eval.slice_fid import SliceFID

    def vol(x):
        n, _, d, h, w = x.shape
        return x.float().reshape(n, 2, d // 2, 2, h // 2, 2, w // 2).mean(
            dim=(2, 4, 6)).reshape(n, 8)

    def sl(x):
        n, _, h, w = x.shape
        return x.float()[:, 0].reshape(n, 2, h // 2, 2, w // 2).mean(
            dim=(2, 4)).reshape(n, 4)

    return vol, SliceFID(extractor=sl)


def jax_extractors():
    from gan3d_tpu.eval.slice_fid import SliceFID

    def vol(x):
        n, d, h, w, _ = x.shape
        return x.reshape(n, 2, d // 2, 2, h // 2, 2, w // 2).mean(
            axis=(2, 4, 6)).reshape(n, 8)

    def sl(x):
        n, h, w, _ = x.shape
        return x[..., 0].reshape(n, 2, h // 2, 2, w // 2).mean(
            axis=(2, 4)).reshape(n, 4)

    return vol, SliceFID(extractor=sl)


def test_calibration_data_vs_data_matches_jax(capsys, numpy_draws):
    from gan3d_tpu.cli.eval_metrics import calibrate as jcalibrate
    from gan3d_tpu_torch.cli.eval_metrics import calibrate

    data = vols(32, 8, 3)
    batches = [data[:16], data[16:]]
    jvol, jsfid = jax_extractors()
    want = jcalibrate(data_batches=[b[..., None] for b in batches], reps=1,
                      size=8, batch=16, fid_features=jvol, sfid=jsfid)
    vol, sfid = port_extractors()
    got = calibrate(data_batches=[torch.from_numpy(b)[:, None]
                                  for b in batches], reps=1, size=8,
                    batch=16, fid_features=vol, sfid=sfid)
    keys = ["SSIM", "MMD", "FIDax", "FIDcor", "FIDsag", "3dFID"]
    assert list(got["data_vs_data"]) == keys
    for k in keys:
        np.testing.assert_allclose(got["data_vs_data"][k],
                                   want["data_vs_data"][k], rtol=1e-4,
                                   err_msg=k)
    out = capsys.readouterr().out
    assert out.count("Metrics vs 2 Data Batches") == 2
    assert "\tFIDcor: " in out


def test_calibration_separates_the_randn_controls():
    """As tests/test_eval_cli.py::test_eval_metrics_calibration_separates
    (2 reps at 16^3, batch 8), with the small extractors."""
    from gan3d_tpu_torch.cli.eval_metrics import calibrate

    vol, sfid = port_extractors()
    res = calibrate(reps=2, size=16, batch=8, fid_features=vol, sfid=sfid)
    assert set(res) == {"randn_vs_randn", "randn_vs_rand"}
    for k in ("3dFID", "FIDax", "MMD"):
        assert res["randn_vs_randn"][k] < res["randn_vs_rand"][k], k


def test_eval_metrics_cli_on_cpu(tmp_path, monkeypatch, capsys):
    from gan3d_tpu_torch.cli import eval_metrics

    vol, sfid = port_extractors()
    monkeypatch.setattr(eval_metrics, "get_fid_model",
                        lambda path, device: vol)
    monkeypatch.setattr(eval_metrics, "SliceFID",
                        lambda weights_path, device: sfid)
    seen = []
    calibrate = eval_metrics.calibrate

    def spy(**kw):
        seen.append(kw)
        return calibrate(**kw)

    monkeypatch.setattr(eval_metrics, "calibrate", spy)
    data = str(tmp_path / "test.npz")
    np.savez(data, X=vols(52, 8, 4))
    res = eval_metrics.main([f"--data_path={data}", "--batch_size=8",
                             f"--fid_checkpoint={tmp_path / 'none.pth'}",
                             "--platform=cpu"])
    out = capsys.readouterr().out
    assert "none.pth not found — random FID features" in out
    # the first six batches of a 7-batch epoch (the 7th would be partial)
    assert [b.shape for b in seen[0]["data_batches"]] == [(8, 1, 8, 8, 8)] * 6
    assert seen[0]["size"] == 8 and set(res) == {
        "data_vs_data", "randn_vs_randn", "randn_vs_rand"}
    res = eval_metrics.main([f"--data_path={tmp_path / 'missing.npz'}",
                             "--batch_size=2", "--fid_checkpoint=",
                             "--platform=cpu"])
    assert seen[1]["size"] == 32 and seen[1]["data_batches"] is None
    assert set(res) == {"randn_vs_randn", "randn_vs_rand"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_metrics.main([f"--data_path={data}"])


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------
CKPT_KEYS = ["step", "modelG_state_dict", "modelD_state_dict",
             "optimizerG_state_dict", "optimizerD_state_dict", "lossG",
             "lossD", "fid"]  # gan3d_tpu/eval/export.py:430-442


@pytest.mark.parametrize("name", ["biggan", "stylegan2"])
def test_export_matches_jax(runs, exported, jax_judge, monkeypatch, name):
    from gan3d_tpu.config import Config as JConfig
    from gan3d_tpu.eval import export as jexport
    from gan3d_tpu.eval.load import load_run as jload_run
    from gan3d_tpu.eval.load import make_sampler as jmake_sampler
    from gan3d_tpu_torch.config import Config
    from gan3d_tpu_torch.eval.load import load_run, make_sampler

    src, (out, path) = runs[name] + "0", exported[name]
    assert path == os.path.join(out, "models", "checkpoint.pt")
    with open(os.path.join(out, "params.pkl"), "rb") as f:
        ns = vars(pickle.load(f))
    want = vars(JConfig.load(src).to_namespace())
    assert ns == vars(Config.load(src).to_namespace())
    shared = set(ns) & set(want)
    assert len(shared) > 50
    assert {k: ns[k] for k in shared} == {k: want[k] for k in shared}

    ckpt = torch.load(path, weights_only=True)
    src_ckpt = torch.load(os.path.join(src, "models", "checkpoint.pt"),
                          weights_only=True)
    assert list(ckpt) == CKPT_KEYS
    assert ckpt["step"] == 2 and ckpt["lossG"] == src_ckpt["lossG"]
    assert ckpt["lossD"] == src_ckpt["lossD"]
    cfg, G, D = load_run(src)
    for net, sd_key, opt_key, lr in (
            (G, "modelG_state_dict", "optimizerG_state_dict", cfg.lrG),
            (D, "modelD_state_dict", "optimizerD_state_dict", cfg.lrD)):
        sd = ckpt[sd_key]
        assert sd.keys() == src_ckpt[sd_key].keys()
        assert all(torch.equal(sd[k], v) for k, v in src_ckpt[sd_key].items())
        assert ckpt[opt_key] == jexport._empty_adam_state(
            jexport._count_torch_params(sd), lr)
        torch.optim.Adam(list(net.parameters())).load_state_dict(
            ckpt[opt_key])

    if name == "biggan":  # the tournament's rival, read from `out`
        jsample = jax_judge[2]
    else:
        # zero per-layer noise on both sides (jax.random.normal in the JAX
        # layer, torch.randn with a generator in the port's)
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype=jnp.float32:
                            jnp.zeros(shape, dtype))
        randn = torch.randn
        monkeypatch.setattr(torch, "randn", lambda *a, **kw: torch.zeros_like(
            randn(*a, **kw)))
        jcfg, jG, _, gv, _ = jload_run(out)
        jsample = jmake_sampler(jcfg, jG, gv)
    z = np.random.default_rng(6).normal(size=(4, cfg.z_size)).astype(
        np.float32)
    want = np.asarray(jsample(jnp.asarray(z)))
    got = make_sampler(cfg, G)(torch.from_numpy(z)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1) / scale,
                               want / scale, rtol=0, atol=1e-4)


def test_export_cli_on_cpu_and_without_cuda(runs, tmp_path, capsys):
    from gan3d_tpu_torch.cli import export_torch

    out = str(tmp_path / "y")
    path = export_torch.main(["--log_dir", runs["biggan"] + "0", "--out",
                              out, "--platform=cpu"])
    assert f"wrote {path} (+ params.pkl)" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["models", "params.pkl"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_torch.main(["--log_dir", runs["biggan"] + "0", "--out",
                           str(tmp_path / "x")])
    assert not os.path.exists(tmp_path / "x")


# ---------------------------------------------------------------------------
# real_ims, make_dir_dataset, the loader
# ---------------------------------------------------------------------------
def test_real_ims_writes_the_jax_cli_file(tmp_path, monkeypatch, capsys):
    from gan3d_tpu.cli import real_ims as jreal_ims
    from gan3d_tpu_torch.cli import real_ims

    np.savez(tmp_path / "test_lidc_8.npz", X=vols(6, 8, 5))
    files = {}
    for pkg, main, extra in (("jax", jreal_ims.main, []),
                             ("torch", real_ims.main, ["--platform=cpu"])):
        os.makedirs(tmp_path / pkg)
        monkeypatch.chdir(tmp_path / pkg)
        main(["--data_path=../test_lidc_8.npz", "--batch_size=4",
              "--seed=2", *extra])
        files[pkg] = np.load("lidc_real.npz")["arr_0"]
    assert files["torch"].shape == (4, 1, 8, 8, 8)
    np.testing.assert_array_equal(files["torch"], files["jax"])
    assert "saved lidc_real.npz (4, 1, 8, 8, 8)" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="no CUDA device"):
        real_ims.main(["--data_path=../test_lidc_8.npz"])


def test_make_dir_dataset_writes_the_jax_cli_files(tmp_path, capsys):
    from gan3d_tpu.cli import make_dir_dataset as jmake
    from gan3d_tpu.data.datasets import NpzDirDataset as JDir
    from gan3d_tpu_torch.cli import make_dir_dataset
    from gan3d_tpu_torch.data import open_dataset

    data = str(tmp_path / "train.npz")
    np.savez(data, X=vols(5, 4, 6) * 2)
    jmake.main([f"--data_path={data}", f"--log_dir={tmp_path / 'jax'}"])
    make_dir_dataset.main([f"--data_path={data}",
                           f"--log_dir={tmp_path / 'torch'}",
                           "--platform=cpu"])
    assert f"wrote 5 samples to {tmp_path / 'torch'}" in \
        capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) == [
        f"{i}.npz" for i in range(5)]
    for n in names:
        np.testing.assert_array_equal(np.load(tmp_path / "torch" / n)["X"],
                                      np.load(tmp_path / "jax" / n)["X"])
    for compat, n in ((False, 5), (True, 4)):
        ours = open_dataset(str(tmp_path / "torch"), compat_len=compat)
        ref = JDir(str(tmp_path / "jax"), compat_len=compat, native=False)
        assert len(ours) == len(ref) == n
        np.testing.assert_array_equal(ours.batch([3, 0]), ref.batch([3, 0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_dir_dataset.main([f"--data_path={data}",
                               f"--log_dir={tmp_path / 'x'}"])


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_epochs_match_jax_loader(tmp_path, shuffle, drop_last):
    """10 samples in batches of 4: 2 batches with drop_last, else 3 (the
    last of 2); the same batches as the JAX loader's, epoch after
    epoch."""
    from gan3d_tpu.data.datasets import NpzDataset as JNpz
    from gan3d_tpu.data.loader import Loader as JLoader
    from gan3d_tpu_torch.data import Loader, open_dataset

    data = str(tmp_path / "test.npz")
    np.savez(data, X=vols(10, 4, 7))
    kw = dict(seed=3, shuffle=shuffle, drop_last=drop_last)
    ours, ref = Loader(open_dataset(data), 4, **kw), JLoader(JNpz(data), 4,
                                                             **kw)
    assert len(ours) == len(ref) == (2 if drop_last else 3)
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert [len(b) for b in got] == ([4, 4] if drop_last else [4, 4, 2])
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
    if not drop_last:
        # a set smaller than one batch makes one partial batch
        assert [len(b) for b in Loader(open_dataset(data), 11, **kw)] == [10]

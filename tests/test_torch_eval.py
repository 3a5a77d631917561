"""The port's evaluation stack (gan3d_tpu_torch/eval/, cli/generate.py,
cli/eval.py) against the JAX package's (gan3d_tpu/eval/, cli/).

- ``mmd``, ``psnr``, ``ms_ssim_3d`` (16^3 and 32^3, where the scale count
  is cut and renormalized, and an odd non-cubic volume, where the pools
  pad) and ``frechet_distance`` on the same inputs (1e-5 relative);
- the MedicalNet ResNet-50 at 16^3 from one random MedicalNet-layout
  ``.pth`` (``module.`` prefixed, BN statistics randomized) read by both
  packages' loaders: the pooled features (1e-4 of the largest);
- Inception-V3 from one random pt_inception state_dict read by both, at
  75x75 (the resize off), and the resize to 299 against
  ``jax.image.resize``;
- ``RandomConvFeatures2D`` with weights carried from the JAX module, at
  even and odd sides (flax's asymmetric SAME padding);
- ``volumes_to_slices`` per axis;
- ``load_run`` + ``make_sampler`` on a 2-step port run (CPU) against the
  JAX ``load_run`` of the same directory (its reference-checkpoint path):
  a BigGAN run at 16^3 (train-mode BN and spectral norm, state
  discarded: two calls agree) and a StyleGAN-1 run at 8^3 (at batch 1,
  where the mixing's permutation is the identity whatever the draws);
- the ``generate`` and ``eval`` CLIs with ``--platform=cpu``: their files,
  keys and shapes (the eval CLI's volume dump, at the 4th batch, by
  ``test_eval_cli_dumps_the_4th_batch``); without it they raise (no card
  here).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan3d_tpu.eval import metrics as JM
from gan3d_tpu.eval import fid_resnet as JR
from gan3d_tpu.eval import inception as JI
from gan3d_tpu.eval import slice_fid as JS
from gan3d_tpu.eval.load import load_run as jload_run
from gan3d_tpu.eval.load import make_sampler as jmake_sampler
from gan3d_tpu_torch.eval import metrics as M
from gan3d_tpu_torch.eval import fid_resnet as R
from gan3d_tpu_torch.eval import inception as I
from gan3d_tpu_torch.eval import slice_fid as S
from gan3d_tpu_torch.eval.load import (load_run, make_discriminator_fn,
                                       make_sampler)

torch.set_num_threads(1)

RNG = np.random.default_rng(11)


def ndhwc(x):
    return jnp.asarray(np.moveaxis(x, 1, -1))


def vols(n, shape, rng=RNG, scale=1.0):
    return np.tanh(rng.normal(size=(n, 1, *shape)) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def test_mmd_and_psnr_match_jax():
    a, b = vols(4, (8, 8, 8)), vols(4, (8, 8, 8), scale=0.5)
    np.testing.assert_allclose(
        float(M.mmd(torch.from_numpy(a), torch.from_numpy(b))),
        float(JM.mmd(ndhwc(a), ndhwc(b))), rtol=1e-5)
    np.testing.assert_allclose(M.psnr(torch.from_numpy(a),
                                      torch.from_numpy(b)),
                               JM.psnr(ndhwc(a), ndhwc(b)), rtol=1e-5)
    assert M.psnr(torch.from_numpy(a), torch.from_numpy(a)) == 100.0


@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 32, 32),
                                   (18, 21, 23)])
def test_ms_ssim_3d_matches_jax(shape):
    a = vols(2, shape)
    b = np.clip(a + 0.3 * RNG.normal(size=a.shape), -1, 1).astype(np.float32)
    got = M.ms_ssim_3d(torch.from_numpy(a), torch.from_numpy(b))
    want = JM.ms_ssim_3d(ndhwc(a), ndhwc(b))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert 0 < got < 1
    # a [N, D, H, W] input is one channel
    np.testing.assert_allclose(
        M.ms_ssim_3d(torch.from_numpy(a[:, 0]), torch.from_numpy(b[:, 0])),
        got, rtol=1e-6)
    assert abs(M.ms_ssim_3d(torch.from_numpy(a), torch.from_numpy(a))
               - 1.0) < 1e-6


def test_frechet_distance_matches_jax():
    a = RNG.normal(size=(40, 12))
    b = RNG.normal(size=(40, 12)) * 1.3 + 0.2
    np.testing.assert_allclose(M.frechet_distance(a, b),
                               JM.frechet_distance(a, b), rtol=1e-10)


# ---------------------------------------------------------------------------
# feature extractors
# ---------------------------------------------------------------------------
def randomize_bn(model):
    """Random BN affines and running statistics (a fresh BN is the
    identity on mean 0 / var 1, which would hide the statistics)."""
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=gen) * 0.5 + 0.75)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=gen) * 0.5 + 0.7)
    return model


def test_fid_resnet_matches_jax_from_one_medicalnet_file(tmp_path):
    model = randomize_bn(R.FIDResNet50())
    path = str(tmp_path / "resnet_50.pth")
    torch.save({"state_dict": {"module." + k: v
                               for k, v in model.state_dict().items()}},
               path)
    x = vols(2, (16, 16, 16))
    got = R.get_fid_model(path)(torch.from_numpy(x)).numpy()
    fmap = jax.jit(JR.FIDResNet50().apply)(JR.load_torch_weights(path),
                                            ndhwc(x))
    want = np.asarray(jnp.mean(fmap, axis=(1, 2, 3)))
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # a checkpoint without the BN counters (torch < 0.4.1) loads too
    torch.save({k: v for k, v in model.state_dict().items()
                if not k.endswith("num_batches_tracked")}, path)
    np.testing.assert_array_equal(
        R.get_fid_model(path)(torch.from_numpy(x)).numpy(), got)


def test_inception_matches_jax_from_one_state_dict(tmp_path):
    model = randomize_bn(I.InceptionV3())
    path = str(tmp_path / "pt_inception.pth")
    torch.save(model.state_dict(), path)
    feats = I.InceptionV3Features(path)
    feats.model.resize = False
    x = RNG.uniform(size=(2, 3, 75, 75)).astype(np.float32)
    got = feats(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(JI.InceptionV3(resize=False).apply)(
        JI.load_torch_weights(path), jnp.asarray(np.moveaxis(x, 1, -1))))
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("hw", [(16, 16), (13, 7)])
def test_inception_resize_matches_jax_image_resize(hw):
    x = RNG.uniform(size=(2, 3, *hw)).astype(np.float32)
    got = I.resize_bilinear(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(np.moveaxis(x, 1, -1)),
                                       (2, 299, 299, 3), "bilinear"))
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), want, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("hw", [(16, 16), (15, 13)])
def test_random_conv_features_match_jax(hw):
    jm = JS.RandomConvFeatures2D()
    v = jm.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    p = jax.tree.map(np.asarray, v["params"])
    model = S.RandomConvFeatures2D()
    with torch.no_grad():
        for i, conv in enumerate(model.convs):
            conv.weight.copy_(torch.tensor(
                p[f"Conv_{i}"]["kernel"].transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.tensor(p[f"Conv_{i}"]["bias"]))
        model.fc.weight.copy_(torch.tensor(p["Dense_0"]["kernel"].T))
        model.fc.bias.copy_(torch.tensor(p["Dense_0"]["bias"]))
        x = RNG.normal(size=(3, 3, *hw)).astype(np.float32)
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(v, jnp.asarray(np.moveaxis(x, 1, -1))))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("axis", ["axial", "coronal", "sagittal"])
def test_volumes_to_slices_match_jax(axis):
    x = RNG.normal(size=(2, 1, 3, 4, 5)).astype(np.float32)
    got = S.volumes_to_slices(torch.from_numpy(x), axis).numpy()
    want = np.asarray(JS._volumes_to_slices(ndhwc(x), axis))
    np.testing.assert_array_equal(np.moveaxis(got, 1, -1), want)
    np.testing.assert_array_equal(
        S.volumes_to_slices(torch.from_numpy(x[:, 0]), axis).numpy(), got)


# ---------------------------------------------------------------------------
# run loading and the CLIs
# ---------------------------------------------------------------------------
# (resolution, flags) of each family's run
FAMILIES = {
    "biggan": (16, ["--biggan=True", "--hinge=True", "--filterG=8",
                    "--filterD=8", "--batch_size=2"]),
    "stylegan": (8, ["--stylegan=True", "--filterG=16", "--filterD=16",
                     "--batch_size=4"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 2-step f32 port run per family (dirs named ``<family>0``, the
    eval CLI's ``path + seed`` naming), each from a 16-volume set at its
    resolution, which is also its test set."""
    from gan3d_tpu_torch.cli.train import main

    root = tmp_path_factory.mktemp("eval_runs")
    out = {}
    for fam, (r, flags) in FAMILIES.items():
        data = str(root / f"test{r}.npz")
        np.savez(data, X=vols(16, (r, r, r), np.random.default_rng(0))[:, 0])
        log_dir = str(root / f"{fam}0")
        main([f"--data_path={data}", f"--log_dir={log_dir}",
              "--platform=cpu", f"--resolution={r}", "--z_size=8",
              "--niters=2", "--data_loader_workers=1",
              "--compute_dtype=float32", *flags])
        out[fam], out[f"data_{fam}"] = log_dir, data
    return out


@pytest.mark.parametrize("fam", ["biggan", "stylegan"])
def test_load_run_and_sampler_match_jax(runs, fam):
    cfg, G, D = load_run(runs[fam])
    assert cfg.family() == fam and G.training and D.training
    jcfg, jG, _, g_vars, _ = jload_run(runs[fam])
    n, r = (1 if fam == "stylegan" else 2), cfg.resolution
    z = np.random.default_rng(2).normal(size=(n, cfg.z_size)).astype(
        np.float32)
    sample = make_sampler(cfg, G)
    got = sample(torch.from_numpy(z))
    again = sample(torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == (n, 1, r, r, r)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    want = np.asarray(jmake_sampler(jcfg, jG, g_vars)(jnp.asarray(z)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1) / scale,
                               want / scale, rtol=0, atol=1e-4)
    score = make_discriminator_fn(cfg, D)(got)
    assert score.shape == (n, 1) and torch.isfinite(score).all()


def test_generate_cli_on_cpu(runs, tmp_path, capsys):
    from gan3d_tpu_torch.cli import generate

    out = str(tmp_path / "fakes.npz")
    generate.main(["-l", runs["biggan"], "--num", "5", "--batch", "2",
                   "--out", out, "--platform=cpu"])
    assert "generated (5, 16, 16, 16)" in capsys.readouterr().out
    x = np.load(out)["X"]
    assert x.shape == (5, 16, 16, 16) and x.dtype == np.float32
    assert np.isfinite(x).all() and np.abs(x).max() <= 1
    generate.main(["-l", runs["stylegan"], "--num", "4", "--batch", "4",
                   "--ncdhw", "--platform=cpu"])
    x = np.load(os.path.join(runs["stylegan"], "generated.npz"))["arr_0"]
    assert x.shape == (4, 1, 8, 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["-l", runs["biggan"], "--out", out])
    with pytest.raises(NotImplementedError, match="slice 8"):
        generate.main(["-l", runs["biggan"], "--num_devices=2",
                       "--platform=cpu"])


def test_eval_cli_on_cpu(runs, tmp_path, capsys):
    from gan3d_tpu_torch.cli import eval as cli_eval

    log_dir = str(tmp_path / "stats")
    model = runs["stylegan"][:-1]
    # one batch: each costs a scipy sqrtm of a 2048^2 matrix (~20 s on a
    # CPU), so the 4th batch's volume dump is not reached
    times = cli_eval.main([
        "-l", model, "--data_path", runs["data_stylegan"], "--batch_size=16",
        "--n_seeds=1", f"--log_dir={log_dir}", "--platform=cpu",
        f"--fid_checkpoint={tmp_path / 'missing.pth'}"])
    out = capsys.readouterr().out
    assert "not found — using randomly-initialized FID features" in out
    assert "SSIM: " in out and "\t3d-FID: " in out
    stats = np.load(os.path.join(log_dir, "stylegan_stats.npz"))
    assert sorted(stats.files) == sorted(["ssim", "mmds", "fid", "fid_ax",
                                          "fid_cor", "fid_sag"])
    for k in stats.files:
        assert stats[k].shape == (1,) and np.isfinite(stats[k]).all(), k
    assert not os.path.exists(f"{runs['stylegan']}_ims.npz")
    assert set(times) == {"sample", "ssim", "fid", "mmd", "slice_fid"}
    assert all(t > 0 for t in times.values())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_eval.main(["-l", model, "--data_path", runs["data_stylegan"]])


def test_eval_cli_dumps_the_4th_batch(runs, tmp_path, monkeypatch):
    """``{run}_ims.npz``: 6 volumes of the 4th batch, NCDHW (here a batch
    of 4). The Fréchet distance is stubbed: its sqrtm of a 2048^2 matrix
    costs ~20 s a batch on a CPU, and test_eval_cli_on_cpu and
    test_frechet_distance_matches_jax run it."""
    from gan3d_tpu_torch.cli import eval as cli_eval
    from gan3d_tpu_torch.eval import slice_fid

    monkeypatch.setattr(M, "frechet_distance", lambda a, b: 0.0)
    monkeypatch.setattr(slice_fid, "frechet_distance", lambda a, b: 0.0)
    cli_eval.main(["-l", runs["stylegan"][:-1], "--data_path",
                   runs["data_stylegan"], "--batch_size=4", "--n_seeds=1",
                   f"--log_dir={tmp_path}", "--platform=cpu",
                   "--fid_checkpoint="])
    ims = np.load(f"{runs['stylegan']}_ims.npz")["arr_0"]
    assert ims.shape == (4, 1, 8, 8, 8) and np.isfinite(ims).all()
    assert np.load(os.path.join(tmp_path, "stylegan_stats.npz"))[
        "ssim"].shape == (4,)


def test_loader_epoch_matches_jax_loader(tmp_path):
    """The eval CLIs' pass over the test set: the port's ``Loader``
    iteration (one shuffled epoch of whole batches) yields the JAX
    loader's batches for the same seed, epoch after epoch."""
    from gan3d_tpu.data.datasets import open_dataset as jopen
    from gan3d_tpu.data.loader import Loader as JLoader
    from gan3d_tpu_torch.data import Loader, open_dataset

    data = str(tmp_path / "test.npz")
    np.savez(data, X=vols(10, (4, 4, 4))[:, 0])
    ours, ref = Loader(open_dataset(data), 4, seed=3), JLoader(jopen(data),
                                                               4, seed=3)
    assert len(ours) == len(ref) == 2
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

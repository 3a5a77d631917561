"""The port's binding of the native npz decoder (gan3d_tpu_torch/data/
native.py) against numpy: the counterparts of tests/test_native_loader.py's
four tests, with its skip when the library cannot be built (no g++ or no
zlib), and the build's place: under gan3d_tpu_torch/_build/, leaving the
repo's native/libnpz_loader.so byte for byte as it was."""

import hashlib
import os
import time

import numpy as np
import pytest

from gan3d_tpu_torch.data import native
from gan3d_tpu_torch.data.datasets import NpzDirDataset, make_dir_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_SO = os.path.join(REPO, "native", "libnpz_loader.so")


def _digest(path):
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native loader unavailable")


def test_decode_matches_numpy(tmp_path):
    rng = np.random.default_rng(0)
    shapes = (4, 6, 5)
    paths = []
    expect = []
    for i, (dtype, compress) in enumerate(
            [(np.float32, True), (np.float32, False),
             (np.float64, True), (np.float64, False)]):
        x = (rng.normal(size=shapes) * 2).astype(dtype)
        p = str(tmp_path / f"{i}.npz")
        (np.savez_compressed if compress else np.savez)(p, X=x)
        paths.append(p)
        expect.append(np.clip(x, -1, 1).astype(np.float32))
    pool = native.NativeNpzPool(2)
    out = pool.decode_batch(paths, shapes)
    np.testing.assert_allclose(out, np.stack(expect), atol=1e-7)


def test_dir_dataset_native_batch(tmp_path):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(10, 4, 4, 4)) * 2).astype(np.float32)
    arch = str(tmp_path / "a.npz")
    np.savez(arch, X=x)
    d = str(tmp_path / "dir")
    make_dir_dataset(arch, d)
    ds_native = NpzDirDataset(d, native=True)
    ds_py = NpzDirDataset(d, native=False)
    assert ds_native._pool is not None and ds_py._pool is None
    idx = [3, 1, 7]
    np.testing.assert_allclose(ds_native.batch(idx), ds_py.batch(idx),
                               atol=1e-7)


def test_error_on_wrong_size(tmp_path):
    x = np.zeros((2, 2), np.float32)
    p = str(tmp_path / "0.npz")
    np.savez(p, X=x)
    pool = native.NativeNpzPool(1)
    with pytest.raises(IOError):
        pool.decode_batch([p], (3, 3))


def test_throughput_sanity(tmp_path):
    """Native batch decode is not slower than 3x numpy (it is typically
    much faster; the loose bound of the JAX package's test)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 32, 32, 32)).astype(np.float32)
    arch = str(tmp_path / "a.npz")
    np.savez(arch, X=x)
    d = str(tmp_path / "dir")
    make_dir_dataset(arch, d)
    idx = list(range(32))

    ds_native = NpzDirDataset(d, native=True, native_threads=4)
    ds_py = NpzDirDataset(d, native=False)
    ds_native.batch(idx)  # warm
    t0 = time.perf_counter()
    for _ in range(3):
        ds_native.batch(idx)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(3):
        ds_py.batch(idx)
    t_py = time.perf_counter() - t0
    print(f"native {t_native:.3f}s vs numpy {t_py:.3f}s")
    assert t_native < 3 * t_py


def test_build_lands_under_the_port_and_leaves_native_so(tmp_path):
    """The port loads its own build under gan3d_tpu_torch/_build/, and a
    build writes only the library it is given: the repo's
    native/libnpz_loader.so stays byte for byte as it was."""
    so = native.library_path()
    assert os.path.isfile(so)
    assert os.path.commonpath([so, native.BUILD_ROOT]) == native.BUILD_ROOT
    assert os.path.realpath(native._load()._name) == os.path.realpath(so)
    before = _digest(REPO_SO)
    out = str(tmp_path / "libnpz_loader.so")
    native._build(out)
    assert os.path.isfile(out)
    assert _digest(REPO_SO) == before

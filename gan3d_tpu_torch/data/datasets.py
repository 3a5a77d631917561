"""npz-backed volume datasets (the port's copy of gan3d_tpu/data/datasets.py).

Semantics match the reference data layer (reference: data_handler.py:7-33):

- ``NpzDataset``: one ``.npz`` archive with array ``X`` of shape [N, D, H, W],
  fully resident in host RAM; samples clipped to [-1, 1] float32.
- ``NpzDirDataset``: a directory of per-sample ``{index}.npz`` files, lazily
  loaded. The reference sets ``len = max(int(filename))`` — NOT the file
  count (an off-by-one quirk, SURVEY §2.3); the port counts max + 1, and
  ``compat_len=True`` reproduces the reference. With ``native=True`` (the
  JAX package's default, gan3d_tpu/data/datasets.py:44-69) a batch is
  decoded by the C++ thread pool of data/native.py, or by numpy, with a
  printed line, where that library cannot be built;
- ``make_dir_dataset``: split a single archive into per-index compressed
  files (reference: make_dir_dataset.py:5-9).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


class NpzDataset:
    """Single-archive dataset (reference: data_handler.py DATA)."""

    def __init__(self, path: str):
        self.data = np.load(path)["X"]
        self.len = self.data.shape[0]

    def __getitem__(self, index: int) -> np.ndarray:
        return np.clip(self.data[index], -1.0, 1.0).astype(np.float32)

    def __len__(self) -> int:
        return self.len

    def batch(self, indices: Sequence[int]) -> np.ndarray:
        out = self.data[np.asarray(indices, np.int64)]
        return np.clip(out, -1.0, 1.0).astype(np.float32)


class NpzDirDataset:
    """Directory-of-files dataset (reference: data_handler.py DATA_DIR)."""

    def __init__(self, path: str, compat_len: bool = False,
                 native: bool = True, native_threads: int = 4):
        self.dir = path
        nums = [int(x[:-4]) for x in os.listdir(path) if x.endswith(".npz")]
        if not nums:
            raise FileNotFoundError(f"no .npz files in {path}")
        # Files are 0-indexed, so a dense range holds max+1 of them.
        self.len = max(nums) if compat_len else max(nums) + 1
        self._pool = None
        self._shape = None
        if native:
            from gan3d_tpu_torch.data.native import NativeNpzPool, available

            try:
                if available():
                    self._pool = NativeNpzPool(native_threads)
                    self._shape = self[min(nums)].shape
            except Exception as e:  # noqa: BLE001 — numpy decodes instead
                print(f"native npz loader disabled: {e}", flush=True)
                self._pool = None

    def __getitem__(self, index: int) -> np.ndarray:
        x = np.load(os.path.join(self.dir, f"{index}.npz"))["X"]
        return np.clip(x, -1.0, 1.0).astype(np.float32)

    def __len__(self) -> int:
        return self.len

    def batch(self, indices: Sequence[int]) -> np.ndarray:
        if self._pool is not None:
            paths = [os.path.join(self.dir, f"{int(i)}.npz") for i in indices]
            return self._pool.decode_batch(paths, self._shape)
        return np.stack([self[int(i)] for i in indices])


def make_dir_dataset(data_path: str, out_dir: str) -> int:
    """Split a single .npz archive into per-index compressed files."""
    os.makedirs(out_dir, exist_ok=True)
    data = np.load(data_path)["X"]
    for i, x in enumerate(data):
        np.savez_compressed(os.path.join(out_dir, f"{i}.npz"), X=x)
    return len(data)


def open_dataset(path: str, compat_len: bool = False):
    """DATA vs DATA_DIR dispatch: files are archives, directories are dirs."""
    if os.path.isdir(path):
        return NpzDirDataset(path, compat_len=compat_len)
    return NpzDataset(path)

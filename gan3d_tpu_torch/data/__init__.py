"""npz datasets (numpy, or the native decoder of data/native.py) and the
batch loader."""

from gan3d_tpu_torch.data.datasets import (NpzDataset, NpzDirDataset,
                                           make_dir_dataset, open_dataset)
from gan3d_tpu_torch.data.loader import Loader

__all__ = ["Loader", "NpzDataset", "NpzDirDataset", "make_dir_dataset",
           "open_dataset"]

"""Dump one shuffled real batch for qualitative comparison (counterpart of
gan3d_tpu/cli/real_ims.py; reference real_ims.py): saves
``{name}_real.npz`` in the cwd with an NCDHW batch. The batch is read on
the host; like every entry point of the port, the CLI asks for the CUDA
card unless ``--platform=cpu``."""

from __future__ import annotations

import argparse

import numpy as np

from gan3d_tpu_torch.data.datasets import open_dataset
from gan3d_tpu_torch.data.loader import Loader
from gan3d_tpu_torch.utils.platform import resolve_device


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--data_path", type=str, default="test_lidc_128.npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", type=str, default="",
                   help="'' = the CUDA card (raises without one), 'cpu'")
    a = p.parse_args(argv)
    resolve_device(a.platform)
    ds = open_dataset(a.data_path)
    batch = next(iter(Loader(ds, a.batch_size, seed=a.seed)))
    # the reference keeps NCDHW in the dump (real_ims.py:13-15)
    name = a.data_path.split("_")[1] if "_" in a.data_path else "data"
    np.savez_compressed(f"{name}_real.npz", batch[:, None])
    print(f"saved {name}_real.npz {batch[:, None].shape}", flush=True)


if __name__ == "__main__":
    main()

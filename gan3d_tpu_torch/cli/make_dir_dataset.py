"""Split one .npz archive into per-index files (counterpart of
gan3d_tpu/cli/make_dir_dataset.py; reference make_dir_dataset.py). Host
work; like every entry point of the port, the CLI asks for the CUDA card
unless ``--platform=cpu``."""

from __future__ import annotations

import argparse

from gan3d_tpu_torch.data.datasets import make_dir_dataset
from gan3d_tpu_torch.utils.platform import resolve_device


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=str, default="train_lidc_128.npz")
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--platform", type=str, default="",
                   help="'' = the CUDA card (raises without one), 'cpu'")
    a = p.parse_args(argv)
    resolve_device(a.platform)
    n = make_dir_dataset(a.data_path, a.log_dir)
    print(f"wrote {n} samples to {a.log_dir}", flush=True)


if __name__ == "__main__":
    main()

"""Training CLI (reference: main.py).

Example (the 64^3 BigGAN-Deep flagship on the card):
    python -m gan3d_tpu_torch.cli.train --data_path=train.npz --log_dir=run \
        --biggan=True --hinge=True --resolution=64 --filterG=64 \
        --filterD=64 --z_size=512 --batch_size=16 --iterD=2
StyleGAN2 at the reference's widths: ``--stylegan2=True --resolution=64
--filterG=128 --filterD=128 --z_size=512 --batch_size=16 --iterD=2``.
Add ``--platform=cpu`` to run on the CPU.
"""

from __future__ import annotations

from gan3d_tpu_torch.config import config_from_args
from gan3d_tpu_torch.data.datasets import open_dataset
from gan3d_tpu_torch.train.trainer import Trainer


def main(argv=None) -> None:
    cfg = config_from_args(argv)
    print(cfg, flush=True)
    Trainer(open_dataset(cfg.data_path), cfg).train()


if __name__ == "__main__":
    main()

"""Training CLI (reference: main.py).

Example (the 64^3 BigGAN-Deep flagship on the card):
    python -m gan3d_tpu_torch.cli.train --data_path=train.npz --log_dir=run \
        --biggan=True --hinge=True --resolution=64 --filterG=64 \
        --filterD=64 --z_size=512 --batch_size=16 --iterD=2
StyleGAN2 at the reference's widths: ``--stylegan2=True --resolution=64
--filterG=128 --filterD=128 --z_size=512 --batch_size=16 --iterD=2``.
Add ``--platform=cpu`` to run on the CPU.

At 128^3 (the reference's defaults, ``--resolution=128 --filterG=128
--filterD=128 --batch_size=16 --biggan=True --hinge=True --remat=True
--remat_scope=stage``) the activations are 8 GiB tensors; unless the
caller set ``PYTORCH_CUDA_ALLOC_CONF``, ``main`` turns on the CUDA
cache's expandable segments before the card is first used, so freed
memory is reusable at any size instead of fragmenting fixed segments.
"""

from __future__ import annotations

import os

from gan3d_tpu_torch.config import config_from_args
from gan3d_tpu_torch.data.datasets import open_dataset
from gan3d_tpu_torch.train.trainer import Trainer


def main(argv=None) -> None:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    cfg = config_from_args(argv)
    print(cfg, flush=True)
    Trainer(open_dataset(cfg.data_path), cfg).train()


if __name__ == "__main__":
    main()

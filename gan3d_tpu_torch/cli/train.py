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

Data parallelism (parallel/dist.py): ``--num_devices=N`` trains on N
cards, one spawned process each (0, the default, = every visible card;
more than are visible raises), the global ``--batch_size`` split over
them; with ``--platform=cpu`` N gloo processes. Across hosts, each host
runs the same command with ``--distributed=True --num_processes=H
--process_id=h --coordinator_address=HOST:PORT`` (the address of host 0,
which holds the rendezvous) and starts its own ranks; rank = h x the
host's ranks + the local rank. ``train_rank`` is one rank's work, for a
caller that starts the processes itself.

Tensor parallelism (parallel/tp.py): ``--model_devices=M`` makes the
ranks a data x model grid, M adjacent ranks (on one host) sharing each
row set and holding a slice each of the wide layers' channels; e.g.
``--num_devices=4 --model_devices=2`` trains on 2 data x 2 model ranks
(``--platform=cpu``: 4 gloo processes).

Spatial parallelism (parallel/sp.py): ``--spatial_devices=S`` makes the
ranks a data x space grid, S adjacent ranks (on one host) sharing each
row set and holding a slab of 1/S of the volume's depth each, with a halo
exchange in every conv; e.g. ``--num_devices=2 --spatial_devices=2`` trains
one row set on 2 space ranks, ``--num_devices=4 --spatial_devices=2`` on 2
data x 2 space ranks. The resolution must divide by S; every family
takes it (BigGAN, the DCGAN family, the hybrid, StyleGAN2, StyleGAN-1),
with ``--remat`` and ``--fused_step=False`` too. At 256^3 the BigGAN-Deep
flagship's widths train on data 1 x space 4 over 4 cards
(``--resolution=256 --num_devices=4 --spatial_devices=4 --remat=True
--fused_step=False``; chip_smoke.py's ``sp_nccl4_r256``).
"""

from __future__ import annotations

import os

from gan3d_tpu_torch.config import Config, config_from_args
from gan3d_tpu_torch.data.datasets import open_dataset
from gan3d_tpu_torch.parallel import dist
from gan3d_tpu_torch.train.trainer import Trainer


def train_rank(replicas: dist.Replicas, cfg: Config) -> None:
    """One rank of a data- or tensor-parallel run."""
    Trainer(open_dataset(cfg.data_path), cfg, replicas).train()


def main(argv=None) -> None:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    cfg = config_from_args(argv)
    print(cfg, flush=True)
    p = dist.plan_for(cfg)
    if p.parallel:
        dist.launch(train_rank, (cfg,), p)
    else:
        Trainer(open_dataset(cfg.data_path), cfg).train()


if __name__ == "__main__":
    main()

"""Batch volume generation (counterpart of gan3d_tpu/cli/generate.py).

Loads a run dir (the port's or a reference torch run, eval/load.py),
samples ``--num`` volumes in batches of ``--batch`` from z drawn by a
generator seeded ``--seed`` on the device, and writes them as an npz:
key "X", [N, D, H, W] float32 in [-1, 1] (dataset-compatible), or with
``--ncdhw`` the reference's NCDHW sample layout [N, 1, D, H, W] as
"arr_0". The steady rate excludes the first batch. Runs on the CUDA card
unless ``--platform=cpu``.

Usage:
    python -m gan3d_tpu_torch.cli.generate -l log/BigGAN0 --num 128 \
        --batch 16 --out fakes.npz
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from gan3d_tpu_torch.eval.load import check_devices, load_run, make_sampler
from gan3d_tpu_torch.utils.platform import configure_precision, resolve_device


def generate(params) -> np.ndarray:
    check_devices(params.num_devices)
    device = resolve_device(params.platform)
    configure_precision(device)
    cfg, G, _ = load_run(params.model_log, params.compute_dtype or None,
                         device)
    sample = make_sampler(cfg, G)
    gen = torch.Generator(device=device)
    gen.manual_seed(params.seed)
    n_batches = -(-params.num // params.batch)
    out, pending = [], None
    t_first = t0 = time.perf_counter()
    for i in range(n_batches):
        x = sample(torch.randn((params.batch, cfg.z_size), generator=gen,
                               device=device))
        if pending is not None:
            out.append(pending.cpu().numpy())
        pending = x
        if i == 0:
            out.append(pending.cpu().numpy())
            pending = None
            t0 = time.perf_counter()  # the first batch is set-up
    if pending is not None:
        out.append(pending.cpu().numpy())
    dt = time.perf_counter() - t0
    vols = np.concatenate(out, axis=0)[:params.num, 0]
    steady = max(n_batches - 1, 1) * params.batch
    print(f"generated {vols.shape} in {time.perf_counter() - t_first:.1f}s "
          f"(steady state {steady / dt:.1f} vol/s)", flush=True)
    return vols


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("-l", "--model_log", type=str, required=True,
                   help="run dir (the port's or a reference torch run)")
    p.add_argument("--num", type=int, default=64)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="",
                   help="output npz (default <model_log>/generated.npz)")
    p.add_argument("--ncdhw", action="store_true",
                   help="dump the reference's NCDHW layout instead of a "
                        "dataset-compatible X=[N,D,H,W] file")
    p.add_argument("--num_devices", type=int, default=1,
                   help="generation devices (one; 0 = all, which must be one)")
    p.add_argument("--compute_dtype", type=str, default="",
                   help="override the run's compute dtype (e.g. bfloat16)")
    p.add_argument("--platform", type=str, default="",
                   help="'' = the CUDA card (raises without one), 'cpu'")
    params = p.parse_args(argv)
    vols = generate(params)
    out = params.out or os.path.join(params.model_log, "generated.npz")
    if params.ncdhw:
        np.savez_compressed(out, vols[:, None])
    else:
        np.savez_compressed(out, X=vols)
    print(f"saved {out}", flush=True)


if __name__ == "__main__":
    main()

"""Metric calibration harness (counterpart of gan3d_tpu/cli/eval_metrics.py;
reference eval_metrics.py).

Sanity-checks every metric (MS-SSIM-3D, MMD, the three slice FIDs, 3D-FID)
on three control pairs x ``reps``:
  1. data batch vs data batch   (distances should be small)
  2. randn vs randn             (self-consistent)
  3. randn vs rand-uniform      (distances should be large)
The randn and uniform volumes come from one ``torch.Generator(seed)`` on
the device, where the JAX CLI splits ``jax.random.key(seed)``: the draws,
and so the controls' values, differ between the packages. The data pass
reads up to six batches, the last one partial. A missing
``--fid_checkpoint`` warns and uses random ResNet-50 features; without
``--inception_checkpoint`` the slice FID uses the random stand-in. Runs on
the CUDA card unless ``--platform=cpu``.

Usage:
    python -m gan3d_tpu_torch.cli.eval_metrics --data_path=test_lidc_128.npz
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gan3d_tpu_torch.data.datasets import open_dataset
from gan3d_tpu_torch.data.loader import Loader
from gan3d_tpu_torch.eval import metrics as M
from gan3d_tpu_torch.eval.fid_resnet import get_fid_model
from gan3d_tpu_torch.eval.slice_fid import SliceFID
from gan3d_tpu_torch.utils.platform import configure_precision, resolve_device


def _summarize(tag: str, rows: List[Dict[str, float]]) -> Dict[str, float]:
    keys = rows[0].keys()
    means = {k: float(np.mean([r[k] for r in rows])) for k in keys}
    stds = {k: float(np.std([r[k] for r in rows])) for k in keys}
    print(f"Metrics {tag}")
    print("\t".join(f"{k}: {means[k]:.2f}+-{stds[k]:.2f}" for k in keys),
          flush=True)
    return means


def calibrate(data_batches: Optional[Sequence[torch.Tensor]] = None,
              reps: int = 3, size: int = 32, batch: int = 8,
              fid_features=None, sfid: Optional[SliceFID] = None,
              seed: int = 0, device: torch.device = torch.device("cpu")
              ) -> Dict[str, Dict[str, float]]:
    """Run the three control comparisons; returns the mean metrics per
    control. ``data_batches`` are NCDHW volumes."""
    if fid_features is None:
        fid_features = get_fid_model(None, device)
    if sfid is None:
        sfid = SliceFID(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (batch, 1, size, size, size)

    def all_metrics(x1, x2):
        x1, x2 = x1.to(device), x2.to(device)
        fa, fc, fs = sfid(x1, x2)
        return {
            "SSIM": M.ms_ssim_3d(x1, x2),
            "MMD": float(M.mmd(x1, x2)),
            "FIDax": fa, "FIDcor": fc, "FIDsag": fs,
            "3dFID": M.fid_3d(fid_features, x1, x2),
        }

    results = {}
    if data_batches is not None:
        rows = []
        for r in range(reps):
            x1 = data_batches[2 * r % len(data_batches)]
            x2 = data_batches[(2 * r + 1) % len(data_batches)]
            rows.append(all_metrics(x1, x2))
        results["data_vs_data"] = _summarize("vs 2 Data Batches", rows)

    rows = []
    for _ in range(reps):
        x1 = torch.randn(shape, generator=gen, device=device)
        x2 = torch.randn(shape, generator=gen, device=device)
        rows.append(all_metrics(x1, x2))
    results["randn_vs_randn"] = _summarize("vs 2 RandN", rows)

    rows = []
    for _ in range(reps):
        x1 = torch.randn(shape, generator=gen, device=device)
        x2 = torch.rand(shape, generator=gen, device=device)
        rows.append(all_metrics(x1, x2))
    results["randn_vs_rand"] = _summarize("vs RandN/RandU", rows)
    return results


def main(argv=None) -> Dict[str, Dict[str, float]]:
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--data_path", type=str, default="test_lidc_128.npz")
    p.add_argument("--fid_checkpoint", type=str, default="resnet_50.pth")
    p.add_argument("--inception_checkpoint", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", type=str, default="",
                   help="'' = the CUDA card (raises without one), 'cpu'")
    a = p.parse_args(argv)
    device = resolve_device(a.platform)
    configure_precision(device)

    fid_ckpt = a.fid_checkpoint if os.path.isfile(a.fid_checkpoint) else None
    if fid_ckpt is None and a.fid_checkpoint:
        print(f"warning: {a.fid_checkpoint} not found — random FID features",
              flush=True)
    fid_features = get_fid_model(fid_ckpt, device)
    sfid = SliceFID(weights_path=a.inception_checkpoint or None,
                    device=device)

    batches = None
    if os.path.exists(a.data_path):
        ds = open_dataset(a.data_path)
        print(len(ds))
        loader = Loader(ds, a.batch_size, seed=a.seed, drop_last=False)
        batches = [torch.from_numpy(b)[:, None]
                   for _, b in zip(range(6), iter(loader))]
        size = batches[0].shape[2]
    else:
        size = 32
    return calibrate(data_batches=batches, size=size, batch=a.batch_size,
                     fid_features=fid_features, sfid=sfid, seed=a.seed,
                     device=device)


if __name__ == "__main__":
    main()

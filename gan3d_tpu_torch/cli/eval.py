"""Offline model evaluation CLI (counterpart of gan3d_tpu/cli/eval.py;
reference eval.py).

For each ``-l`` run dir x ``--n_seeds`` seeds (``path+'0'``, ``path+'1'``
...): rebuild G from the run's params and checkpoint, loop one epoch of the
test set computing MS-SSIM-3D, MMD, 3D-FID and the per-axis slice FID per
batch against as many generated volumes, dump 6 generated volumes of the
4th batch (``{run}_ims.npz``, NCDHW), print mean±std and save
``{model}_stats.npz`` (keys ssim, mmds, fid, fid_ax, fid_cor, fid_sag)
in ``--log_dir``. A missing ``--fid_checkpoint`` warns and uses random
features; without ``--inception_checkpoint`` the slice FID uses the random
stand-in. Runs on the CUDA card unless ``--platform=cpu``.

``main`` returns the seconds a batch of each metric (and of the sampler):
the mean over the batches after the first of each run, or over the first
batches where every run has one.

Usage:
    python -m gan3d_tpu_torch.cli.eval -l log/BigGAN \
        --data_path=test_lidc_128.npz --fid_checkpoint=resnet_50.pth
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from gan3d_tpu_torch.data.datasets import open_dataset
from gan3d_tpu_torch.data.loader import Loader
from gan3d_tpu_torch.eval import metrics as M
from gan3d_tpu_torch.eval.fid_resnet import get_fid_model
from gan3d_tpu_torch.eval.load import check_devices, load_run, make_sampler
from gan3d_tpu_torch.eval.slice_fid import SliceFID
from gan3d_tpu_torch.utils.platform import configure_precision, resolve_device

KEYS = ("ssim", "mmds", "fid", "fid_ax", "fid_cor", "fid_sag")


def evaluate(params) -> Dict[str, float]:
    check_devices(params.num_devices)
    device = resolve_device(params.platform)
    configure_precision(device)
    dataset = open_dataset(params.data_path)
    print(len(dataset))
    loader = Loader(dataset, params.batch_size, seed=params.seed)
    fid_features = get_fid_model(params.fid_checkpoint or None, device)
    sfid = SliceFID(weights_path=params.inception_checkpoint or None,
                    device=device)
    os.makedirs(params.log_dir, exist_ok=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(params.seed)
    times: Dict[str, List[Tuple[int, float]]] = {}

    def timed(name, i, fn, *args):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.setdefault(name, []).append((i, time.perf_counter() - t))
        return out

    for model_path in params.model_log:
        print(model_path, flush=True)
        stats = {k: [] for k in KEYS}
        for j in range(params.n_seeds):
            run = model_path + f"{j}"
            cfg, G, _ = load_run(run, device=device)
            sample = make_sampler(cfg, G)
            for i, data in enumerate(loader):
                x1 = torch.from_numpy(data).to(device)[:, None]
                z = torch.randn((data.shape[0], cfg.z_size), generator=gen,
                                device=device)
                x2 = timed("sample", i, sample, z)
                stats["ssim"].append(timed("ssim", i, M.ms_ssim_3d, x1, x2))
                stats["fid"].append(timed("fid", i, M.fid_3d, fid_features,
                                          x1, x2))
                stats["mmds"].append(float(timed("mmd", i, M.mmd, x1, x2)))
                fa, fc, fs = timed("slice_fid", i, sfid, x1, x2)
                stats["fid_ax"].append(fa)
                stats["fid_cor"].append(fc)
                stats["fid_sag"].append(fs)
                if i == 3:
                    np.savez_compressed(f"{run}_ims.npz",
                                        x2[:6].cpu().numpy())
        arr = {k: np.asarray(v) for k, v in stats.items()}
        print(f"SSIM: {arr['ssim'].mean():.2f}+-{arr['ssim'].std():.2f}"
              f"\tMMD: {arr['mmds'].mean():.2f}+-{arr['mmds'].std():.2f}"
              f"\tFID ax: {arr['fid_ax'].mean():.1f}+-{arr['fid_ax'].std():.1f}"
              f"\tFID cor: {arr['fid_cor'].mean():.1f}+-{arr['fid_cor'].std():.1f}"
              f"\tFID sag: {arr['fid_sag'].mean():.1f}+-{arr['fid_sag'].std():.1f}"
              f"\t3d-FID: {arr['fid'].mean():.2f}+-{arr['fid'].std():.2f}",
              flush=True)
        p = model_path.rstrip("/").split("/")[-1]
        np.savez_compressed(os.path.join(params.log_dir, f"{p}_stats.npz"),
                            **arr)
    # the first batch of a run sets up (cuDNN plans, allocations)
    return {k: float(np.mean([t for i, t in v if i > 0]
                             or [t for _, t in v]))
            for k, v in times.items()}


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--data_path", type=str, default="test_lidc_128.npz")
    parser.add_argument("--log_dir", type=str, default="log")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num_devices", type=int, default=1,
                        help="evaluation devices (one; 0 = all, which must "
                             "be one)")
    parser.add_argument("--n_seeds", type=int, default=3,
                        help="run dirs per model: path+0..path+N-1")
    parser.add_argument("-l", "--model_log", action="append", type=str,
                        required=True)
    parser.add_argument("--fid_checkpoint", type=str, default="resnet_50.pth",
                        help="MedicalNet weights; '' = random features")
    parser.add_argument("--inception_checkpoint", type=str, default="",
                        help="Inception weights for slice FID; '' = random "
                             "feature stand-in")
    parser.add_argument("--platform", type=str, default="",
                        help="'' = the CUDA card (raises without one), 'cpu'")
    params = parser.parse_args(argv)
    if params.fid_checkpoint and not os.path.isfile(params.fid_checkpoint):
        print(f"warning: {params.fid_checkpoint} not found — using "
              "randomly-initialized FID features", flush=True)
        params.fid_checkpoint = ""
    return evaluate(params)


if __name__ == "__main__":
    main()

"""Cross-model discriminator-judged tournament (counterpart of
gan3d_tpu/cli/tournament.py; reference tournament.py).

For every judge model (its D and its own G), the decision bound is the
midpoint of mean D(real) and mean D(G_own(z)) over the test set; every
rival G then plays ``rounds`` rounds of ``batch_size`` fakes, scoring the
fraction that clear the bound; the mean win rate per G is printed and
returned (reference tournament.py:35-98). Scores and samples run through
eval/load.py (train-mode forwards under no_grad, state discarded).

Deviation from the reference (documented, SURVEY §2.3): the reference
resets its real/fake score accumulators inside the data loop
(tournament.py:38), so the bound uses only the LAST batch. Both packages
accumulate over all batches by default; ``--compat_last_batch``
reproduces the reference.

All noise comes from ``_noise``, drawing from one ``torch.Generator(seed)``
on the device, where the JAX CLI splits ``jax.random.key(seed)``: the
draws, and so the win rates, differ between the packages. Runs on the CUDA
card unless ``--platform=cpu``.

Usage:
    python -m gan3d_tpu_torch.cli.tournament -l log/BigGAN -l log/DCGAN \
        --data_path=test_lidc_128.npz --n_seeds=3
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from gan3d_tpu_torch.data.datasets import open_dataset
from gan3d_tpu_torch.data.loader import Loader
from gan3d_tpu_torch.eval.load import (check_devices, load_run,
                                       make_discriminator_fn, make_sampler)
from gan3d_tpu_torch.eval.metrics import to_numpy
from gan3d_tpu_torch.utils.platform import configure_precision, resolve_device


def _noise(gen: torch.Generator, n: int, z_size: int) -> torch.Tensor:
    """[n, z_size] standard normal noise on the generator's device."""
    return torch.randn((n, z_size), generator=gen, device=gen.device)


def get_decision_bound(score, sample, z_size: int, loader,
                       gen: torch.Generator,
                       compat_last_batch: bool = False) -> float:
    rs: List[np.ndarray] = []
    fs: List[np.ndarray] = []
    for x in loader:
        if compat_last_batch:
            rs, fs = [], []
        x = torch.from_numpy(x)[:, None]
        noise = _noise(gen, x.shape[0], z_size)
        rs.append(to_numpy(score(x)).ravel())
        fs.append(to_numpy(score(sample(noise))).ravel())
    r = np.concatenate(rs)
    f = np.concatenate(fs)
    return float((r.mean() + f.mean()) / 2.0)


def play_round(score, sample, z_size: int, bound: float, batch_size: int,
               gen: torch.Generator, rounds: int = 2) -> float:
    wins = 0
    for _ in range(rounds):
        f = to_numpy(score(sample(_noise(gen, batch_size, z_size)))).ravel()
        wins += int((f > bound).sum())
    return wins / (batch_size * rounds)


def tournament(loader, params) -> Dict[str, float]:
    check_devices(params.num_devices)
    device = resolve_device(params.platform)
    configure_precision(device)
    names = params.model_log
    res: Dict[str, List[float]] = {n: [] for n in names}
    gen = torch.Generator(device=device)
    gen.manual_seed(params.seed)
    for name_d in names:
        for k in range(params.n_seeds):
            cfg_d, G_d, D_d = load_run(name_d + f"{k}", device=device)
            score = make_discriminator_fn(cfg_d, D_d)
            bound = get_decision_bound(score, make_sampler(cfg_d, G_d),
                                       cfg_d.z_size, loader, gen,
                                       params.compat_last_batch)
            for name_g in names:
                if name_d == name_g:
                    continue
                for m in range(params.n_seeds):
                    cfg_g, G_g, _ = load_run(name_g + f"{m}", device=device)
                    wr = play_round(score, make_sampler(cfg_g, G_g),
                                    cfg_g.z_size, bound, params.batch_size,
                                    gen)
                    res[name_g].append(wr)

    print("------------- Tournament Results -------------")
    means = {}
    for n in names:
        means[n] = float(np.mean(res[n])) if res[n] else float("nan")
        print(f"G of {n} with Mean Win Rate of {means[n]:.2f}")
    return means


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--data_path", type=str, default="test_lidc_128.npz")
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_seeds", type=int, default=3)
    p.add_argument("--num_devices", type=int, default=1,
                   help="evaluation devices (one; 0 = all, which must be "
                        "one)")
    p.add_argument("--compat_last_batch", action="store_true",
                   help="reproduce the reference's last-batch-only bound")
    p.add_argument("-l", "--model_log", action="append", type=str,
                   required=True)
    p.add_argument("--platform", type=str, default="",
                   help="'' = the CUDA card (raises without one), 'cpu'")
    params = p.parse_args(argv)

    dataset = open_dataset(params.data_path)
    print(len(dataset))
    loader = Loader(dataset, params.batch_size, seed=params.seed,
                    drop_last=False)
    return tournament(loader, params)


if __name__ == "__main__":
    main()

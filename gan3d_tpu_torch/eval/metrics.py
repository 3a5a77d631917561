"""Metric functions: MMD, PSNR, MS-SSIM-3D, Fréchet distance, 3D-FID.

Counterpart of gan3d_tpu/eval/metrics.py (reference eval_utils.py:11-52),
on NCDHW tensors (a [N, D, H, W] input is one channel):

- ``mmd``: the reference's linear-kernel estimator on flattened volumes,
  diagonal terms included (metrics.py:32-42);
- ``psnr``: on [-1, 1] data, 10 log10(4 / mse), 100 for equal inputs;
- ``ms_ssim_3d`` (metrics.py:54-137): pytorch_msssim's MS-SSIM over three
  spatial axes on (x + 1) / 2, the 7-tap gaussian (sigma 1.5) as three
  valid depthwise convs, 5 scales with weights (0.0448, 0.2856, 0.3001,
  0.2363, 0.1333); fewer scales while (win - 1) * 2^(scales - 1) >= the
  smallest side, their weights renormalized; relu on cs and ssim; before
  each 2x average pool an odd side is padded by one zero at its end;
- ``frechet_distance``: Gaussian fits of two feature sets, the covariance
  product's square root by ``scipy.linalg.sqrtm`` in f64 on the host;
- ``fid_3d``: the Fréchet distance of a feature function's outputs.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).float()


def mmd(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Linear-kernel MMD (the reference estimator), a 0-d f32 tensor."""
    b = real.shape[0]
    y, x = _flat(real), _flat(fake)
    beta, gamma = 1.0 / (b * b), 2.0 / (b * b)
    return beta * ((x @ x.T).sum() + (y @ y.T).sum()) - gamma * (x @ y.T).sum()


def psnr(real: torch.Tensor, fake: torch.Tensor) -> float:
    """PSNR on [-1, 1] volumes (peak-to-peak 2)."""
    mse = float(torch.mean(((real.float() + 1) - (fake.float() + 1)) ** 2))
    if mse == 0:
        return 100.0
    return float(10.0 * np.log10(4.0 / mse))


def _gaussian_window(win_size: int, sigma: float,
                     device: torch.device) -> torch.Tensor:
    coords = (torch.arange(win_size, dtype=torch.float32, device=device)
              - (win_size - 1) / 2.0)
    g = torch.exp(-coords ** 2 / (2 * sigma * sigma))
    return g / g.sum()


def _filter3d_separable(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Valid-mode gaussian over D, H, W of [N, C, D, H, W], per channel."""
    c, k = x.shape[1], win.shape[0]
    for axis in range(3):
        shape = [c, 1, 1, 1, 1]
        shape[2 + axis] = k
        x = F.conv3d(x, win.reshape(shape).to(x.dtype), groups=c)
    return x


def _ssim_3d(x: torch.Tensor, y: torch.Tensor, win: torch.Tensor,
             data_range: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample mean (ssim, cs)."""
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    f = lambda t: _filter3d_separable(t, win)  # noqa: E731
    mu_x, mu_y = f(x), f(y)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = f(x * x) - mu_xx
    sigma_y = f(y * y) - mu_yy
    sigma_xy = f(x * y) - mu_xy
    cs_map = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs_map
    dims = tuple(range(1, x.ndim))
    return ssim_map.mean(dim=dims), cs_map.mean(dim=dims)


def _avg_pool2_pad(x: torch.Tensor) -> torch.Tensor:
    d, h, w = x.shape[2:]
    x = F.pad(x, (0, w % 2, 0, h % 2, 0, d % 2))
    n, c, d, h, w = x.shape
    return x.reshape(n, c, d // 2, 2, h // 2, 2, w // 2, 2).mean(dim=(3, 5, 7))


def ms_ssim_3d(real: torch.Tensor, fake: torch.Tensor, win_size: int = 7,
               sigma: float = 1.5, data_range: float = 1.0,
               weights: Sequence[float] = MSSSIM_WEIGHTS,
               rescale_from_minus1: bool = True) -> float:
    """MS-SSIM over three spatial axes; with ``rescale_from_minus1`` (the
    reference's (x + 1) / 2) inputs in [-1, 1] map to [0, 1]."""
    x, y = real.float(), fake.float()
    if x.ndim == 4:
        x, y = x[:, None], y[:, None]
    if rescale_from_minus1:
        x, y = (x + 1) / 2, (y + 1) / 2
    min_side = min(x.shape[2:])
    levels = len(weights)
    while levels > 1 and (win_size - 1) * (2 ** (levels - 1)) >= min_side:
        levels -= 1
    w = torch.tensor(weights[:levels], dtype=torch.float32, device=x.device)
    if levels < len(weights):
        w = w / w.sum()
    win = _gaussian_window(win_size, sigma, x.device)
    mcs = []
    for i in range(levels):
        ssim_val, cs = _ssim_3d(x, y, win, data_range)
        if i < levels - 1:
            mcs.append(torch.relu(cs))
            x, y = _avg_pool2_pad(x), _avg_pool2_pad(y)
    terms = mcs + [torch.relu(ssim_val)]
    out = torch.stack([t ** wi for t, wi in zip(terms, w)], 0).prod(dim=0)
    return float(out.mean())


def frechet_distance(act1: np.ndarray, act2: np.ndarray) -> float:
    """Fréchet distance between Gaussian fits of two [N, F] feature sets
    (f64 on the host, scipy's sqrtm; its real part where it is complex)."""
    from scipy.linalg import sqrtm

    act1 = np.asarray(act1, np.float64)
    act2 = np.asarray(act2, np.float64)
    mu1, sigma1 = act1.mean(axis=0), np.cov(act1, rowvar=False)
    mu2, sigma2 = act2.mean(axis=0), np.cov(act2, rowvar=False)
    ssdiff = np.sum((mu1 - mu2) ** 2.0)
    covmean = sqrtm(sigma1.dot(sigma2))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(ssdiff + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def fid_3d(feature_fn: Callable[[torch.Tensor], torch.Tensor],
           real: torch.Tensor, fake: torch.Tensor) -> float:
    """3D-FID: the Fréchet distance of ``feature_fn``'s [N, F] features."""
    return frechet_distance(to_numpy(feature_fn(real)),
                            to_numpy(feature_fn(fake)))

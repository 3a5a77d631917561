"""Per-axis 2D slice FID (counterpart of gan3d_tpu/eval/slice_fid.py;
reference eval_utils.py:65-84).

Volumes become stacks of 2-D slices along the three axes (axial: over D;
coronal: D and H swapped; sagittal: W and D swapped, the reference's
NCDHW transpose(2, 3) / transpose(4, 2)), each slice repeated to 3
channels, and the FID of each axis is taken over features of batches of
128 slices. The extractor is Inception-V3 with a pt_inception weights file
(``weights_path``), else a frozen random CNN seeded 0
(``RandomConvFeatures2D``, the JAX package's stand-in: its distances
separate distributions but are not Inception FIDs; a warning says so).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gan3d_tpu_torch.eval.metrics import frechet_distance, to_numpy


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax's ``padding="SAME"`` for a k x k, stride-s conv of [N, C, H,
    W]: per side (total // 2, total - total // 2) with total = max((ceil(n
    / s) - 1) * s + k - n, 0); at stride 2 and an even side that is (0, 1),
    which torch's symmetric ``padding`` cannot say."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class RandomConvFeatures2D(nn.Module):
    """Frozen random CNN: [N, 3, H, W] -> [N, dim] (three 3x3 stride-2
    convs with relu, the spatial mean, a linear)."""

    def __init__(self, dim: int = 256):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(ci, co, 3, 2)
                                   for ci, co in ((3, 32), (32, 64),
                                                  (64, 128)))
        self.fc = nn.Linear(128, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for conv in self.convs:
            x = F.relu(conv(same_pad(x, 3, 2)))
        return self.fc(x.mean(dim=(2, 3)))


def volumes_to_slices(v: torch.Tensor, axis: str) -> torch.Tensor:
    """[N, 1, D, H, W] or [N, D, H, W] -> [N * S, 3, side, side]."""
    if v.ndim == 5:
        v = v[:, 0]
    if axis == "coronal":
        v = v.transpose(1, 2)
    elif axis == "sagittal":
        v = v.transpose(3, 1)
    n, d, h, w = v.shape
    return v.reshape(n * d, 1, h, w).expand(n * d, 3, h, w)


class SliceFID:
    def __init__(self, extractor: Optional[Callable] = None,
                 weights_path: Optional[str] = None, batch_size: int = 128,
                 device: torch.device = torch.device("cpu")):
        self.batch_size, self.device = batch_size, device
        if extractor is not None:
            self._features = extractor
        elif weights_path:
            from gan3d_tpu_torch.eval.inception import InceptionV3Features

            self._features = InceptionV3Features(weights_path, device)
        else:
            print("SliceFID: no Inception weights — using a frozen "
                  "random-feature extractor (values not comparable to "
                  "Inception FID)", flush=True)
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                model = RandomConvFeatures2D().eval()
            self.model = model.to(device)

            def features(x: torch.Tensor) -> torch.Tensor:
                with torch.no_grad():
                    return self.model(x)

            self._features = features

    def _acts(self, slices: torch.Tensor) -> np.ndarray:
        slices = slices.to(self.device)
        return np.concatenate([
            to_numpy(self._features(slices[i:i + self.batch_size]))
            for i in range(0, slices.shape[0], self.batch_size)])

    def _fid_axis(self, real, fake, axis: str) -> float:
        return frechet_distance(self._acts(volumes_to_slices(real, axis)),
                                self._acts(volumes_to_slices(fake, axis)))

    def axial(self, fake, real) -> float:
        return self._fid_axis(real, fake, "axial")

    def __call__(self, real, fake) -> Tuple[float, float, float]:
        """(fid_ax, fid_cor, fid_sag), like the reference's eval_utils.fid."""
        return (self._fid_axis(real, fake, "axial"),
                self._fid_axis(real, fake, "coronal"),
                self._fid_axis(real, fake, "sagittal"))

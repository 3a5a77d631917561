"""Inception-V3 (the FID variant) feature extractor, NCHW.

Counterpart of gan3d_tpu/eval/inception.py (the pytorch_fid backbone
behind the reference's slice FID, eval_utils.py:65-84): torchvision's
inception_v3 graph with the FID patches: the branch pools of InceptionA,
C and E average 3x3 with ``count_include_pad=False``, and the last
InceptionE max-pools; BN eps 1e-3 on running statistics; the TF
preprocessing, a bilinear resize to 299 (``F.interpolate``,
align_corners=False, no antialias: for an upsampling the taps of
``jax.image.resize``'s "bilinear") and x * 2 - 1 on [0, 1] input. The
features are the 2048-d global average pool.

The module names are pytorch_fid's (``Mixed_5b.branch1x1.conv`` / ``.bn``
...), so its pt_inception state_dict loads directly (``fc.*`` dropped).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3
SIZE = 299

Pad = Union[int, Sequence[int]]


class ConvBN(nn.Module):
    """conv (no bias) + BN (eps 1e-3, running statistics) + relu."""

    def __init__(self, ci: int, co: int, kernel, stride: int = 1,
                 padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(ci, co, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(co, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, ci: int, pool_features: int):
        super().__init__()
        self.branch1x1 = ConvBN(ci, 64, 1)
        self.branch5x5_1 = ConvBN(ci, 48, 1)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBN(ci, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1)
        self.branch_pool = ConvBN(ci, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, ci: int):
        super().__init__()
        self.branch3x3 = ConvBN(ci, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBN(ci, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, ci: int, c7: int):
        super().__init__()
        self.branch1x1 = ConvBN(ci, 192, 1)
        self.branch7x7_1 = ConvBN(ci, c7, 1)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(ci, c7, 1)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(ci, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, ci: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(ci, 192, 1)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBN(ci, 192, 1)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, ci: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool  # pytorch_fid's FIDInceptionE_2
        self.branch1x1 = ConvBN(ci, 320, 1)
        self.branch3x3_1 = ConvBN(ci, 384, 1)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(ci, 448, 1)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(ci, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = (F.max_pool2d(x, 3, 1, 1) if self.use_max_pool
              else _avg_pool(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         1)


def resize_bilinear(x: torch.Tensor, size: int = SIZE) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, size, size], half-pixel bilinear taps."""
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=False)


class InceptionV3(nn.Module):
    """[N, 3, H, W] in [0, 1] -> the 2048-d pooled FID features."""

    def __init__(self, resize: bool = True):
        super().__init__()
        self.resize = resize
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)
        self.eval()

    def train(self, mode: bool = True) -> "InceptionV3":
        return super().train(False)  # BN on running statistics, always

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.resize and tuple(x.shape[2:]) != (SIZE, SIZE):
            x = resize_bilinear(x)
        x = x * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a",
                     "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.mean(dim=(2, 3))


class InceptionV3Features:
    """Callable [N, 3, H, W] -> [N, 2048] on ``device``: a pt_inception
    state_dict from ``weights_path``, else a random init from seed 0."""

    def __init__(self, weights_path: Optional[str] = None,
                 device: torch.device = torch.device("cpu")):
        from gan3d_tpu_torch.eval.fid_resnet import load_strict

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.model = InceptionV3()
        if weights_path:
            sd = torch.load(weights_path, map_location="cpu",
                            weights_only=False)
            if hasattr(sd, "state_dict"):
                sd = sd.state_dict()
            load_strict(self.model, {k: v for k, v in sd.items()
                                     if not k.startswith("fc.")})
        self.model = self.model.to(device)
        self.device = device

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.model(x.to(self.device))

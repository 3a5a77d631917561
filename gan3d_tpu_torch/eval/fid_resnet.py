"""MedicalNet 3D ResNet-50 feature extractor for 3D-FID (NCDHW).

Counterpart of gan3d_tpu/eval/fid_resnet.py (reference FID_ResNet.py
:105-189): Bottleneck blocks (3, 4, 6, 3) of widths 64/128/256/512 (x 4
out), strides (1, 2, 1, 1) and dilations (1, 1, 2, 4), shortcut type B
(1x1 conv + BN); a 7^3 stride-2 stem, BN, relu and a 3^3 stride-2 max pool
(padding 1). BN uses its running statistics (eps 1e-5): the network stays
in eval mode whatever ``train()`` asks. The features are the spatial mean
of layer4's map, [N, 2048], in f32.

The module names are MedicalNet's (``conv1``, ``bn1``, ``layer{i}.{b}.
conv{1,2,3}`` / ``bn{1,2,3}`` / ``downsample.{0,1}``), so its
``resnet_50.pth`` loads as a state_dict after the ``module.`` prefix is
stripped (``load_medicalnet``, as gan3d_tpu/eval/fid_resnet.py:88-137
reads it). The convs are the port's ``Conv3d``, so an eligible k3 conv
goes through ``ops/conv3d.conv3d``; the eval entry points leave the conv
knobs off, as the JAX package does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan3d_tpu_torch.nn.layers import Conv3d

LAYERS = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
STRIDES = (1, 2, 1, 1)
DILATIONS = (1, 1, 2, 4)
EXPANSION = 4


class _Conv(Conv3d):
    """A biasless port Conv3d with a dilation (F.conv3d takes it; the
    dispatcher's kernel routes take only undilated k3/s1/p1 convs)."""

    def __init__(self, ci: int, co: int, k: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1):
        super().__init__(ci, co, k, stride, padding, bias=False)
        self.dilation = (dilation,) * 3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dilation != (1, 1, 1):
            return F.conv3d(x, self.weight.to(x.dtype), None, self.stride,
                            self.padding, self.dilation)
        return super().forward(x)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        out = planes * EXPANSION
        self.conv1 = _Conv(inplanes, planes, 1)
        self.bn1 = nn.BatchNorm3d(planes)
        self.conv2 = _Conv(planes, planes, 3, stride, dilation, dilation)
        self.bn2 = nn.BatchNorm3d(planes)
        self.conv3 = _Conv(planes, out, 1)
        self.bn3 = nn.BatchNorm3d(out)
        self.downsample = (nn.Sequential(_Conv(inplanes, out, 1, stride),
                                         nn.BatchNorm3d(out))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(h + sc)


class FIDResNet50(nn.Module):
    """[N, 1, D, H, W] -> layer4's map [N, 2048, D', H', W'] (f32)."""

    def __init__(self):
        super().__init__()
        self.conv1 = _Conv(1, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm3d(64)
        inplanes = 64
        for li, (blocks, planes, stride, dilation) in enumerate(
                zip(LAYERS, WIDTHS, STRIDES, DILATIONS), start=1):
            mods = []
            for bi in range(blocks):
                need_ds = bi == 0 and (stride != 1
                                       or inplanes != planes * EXPANSION)
                mods.append(Bottleneck(inplanes, planes,
                                       stride if bi == 0 else 1, dilation,
                                       need_ds))
                inplanes = planes * EXPANSION
            setattr(self, f"layer{li}", nn.Sequential(*mods))
        self.eval()

    def train(self, mode: bool = True) -> "FIDResNet50":
        return super().train(False)  # BN on running statistics, always

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x.float())))
        x = F.max_pool3d(x, 3, 2, 1)
        for li in range(1, len(LAYERS) + 1):
            x = getattr(self, f"layer{li}")(x)
        return x


def load_medicalnet(path: str) -> Dict[str, torch.Tensor]:
    """The MedicalNet checkpoint's state_dict (under "state_dict" or at
    the top level), ``module.`` stripped, keys of other heads dropped."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw)
    sd = {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}
    return {k: v for k, v in sd.items()
            if k.split(".")[0] in ("conv1", "bn1") or k.startswith("layer")}


def load_strict(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """``load_state_dict`` that admits one gap: the BN counters
    (``num_batches_tracked``), which checkpoints from before torch 0.4.1
    lack and inference never reads."""
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")


def get_fid_model(path: Optional[str] = None,
                  device: torch.device = torch.device("cpu")
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The feature function [N, 1, D, H, W] -> [N, 2048] f32 on ``device``:
    MedicalNet's weights from ``path``, else a random init from seed 0."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = FIDResNet50()
    if path:
        load_strict(model, load_medicalnet(path))
    model = model.to(device)

    def features(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(x.to(device)).mean(dim=(2, 3, 4))

    return features

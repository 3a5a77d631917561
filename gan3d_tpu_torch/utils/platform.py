"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(platform: str = "") -> torch.device:
    """``""``: the CUDA card, raising when there is none;
    ``"cpu"``: the CPU. No other value is accepted and nothing falls back."""
    if platform == "":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass --platform=cpu to run on "
                "the CPU")
        return torch.device("cuda")
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"platform {platform!r} not in ('', 'cpu')")


def configure_precision(device: torch.device) -> None:
    """Full-f32 matmuls and convolutions on the card (no TF32): f32 work
    such as the spectral-norm power iteration, and whole runs with
    ``compute_dtype=float32``, keep f32 precision as in the JAX package."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

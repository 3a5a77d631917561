"""Models: the BigGAN family and the family registry."""

from gan3d_tpu_torch.models.registry import build_models

__all__ = ["build_models"]

"""The StyleGAN2-3D family (counterpart of gan3d_tpu/models/stylegan/):
FIR resampling, modulated conv, mapping, G, D and the fused step's loss.
StyleGAN-1 (stylegan1.py) is not ported yet."""

from gan3d_tpu_torch.models.stylegan.discriminator import Discriminator
from gan3d_tpu_torch.models.stylegan.generator import Generator

__all__ = ["Generator", "Discriminator"]

"""The StyleGAN-3D families (counterpart of gan3d_tpu/models/stylegan/):
StyleGAN2's FIR resampling, modulated conv, mapping, G and D, StyleGAN-1's
AdaIN G (stylegan1.py, with StyleGAN2's D), and the fused step's loss."""

from gan3d_tpu_torch.models.stylegan.discriminator import Discriminator
from gan3d_tpu_torch.models.stylegan.generator import Generator
from gan3d_tpu_torch.models.stylegan.stylegan1 import StyleGAN1Generator

__all__ = ["Generator", "Discriminator", "StyleGAN1Generator"]

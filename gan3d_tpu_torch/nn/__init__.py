"""Layers: SN conv/linear, ConvTranspose3d, BatchNorm3d, LayerNormVolume,
RandomCrop3D, SelfAttention3d, deep blocks."""

from gan3d_tpu_torch.nn.attention import SelfAttention3d
from gan3d_tpu_torch.nn.blocks import DBlockDeep, GBlockDeep
from gan3d_tpu_torch.nn.layers import (Conv3d, ConvTranspose3d, Linear,
                                       SNConv3d, SNLinear)
from gan3d_tpu_torch.nn.msl import RandomCrop3D
from gan3d_tpu_torch.nn.norm import BatchNorm3d, LayerNormVolume

__all__ = ["BatchNorm3d", "Conv3d", "ConvTranspose3d", "DBlockDeep",
           "GBlockDeep", "LayerNormVolume", "Linear", "RandomCrop3D",
           "SNConv3d", "SNLinear", "SelfAttention3d"]

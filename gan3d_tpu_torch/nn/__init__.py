"""Layers: SN conv/linear, BatchNorm3d, SelfAttention3d, deep blocks."""

from gan3d_tpu_torch.nn.attention import SelfAttention3d
from gan3d_tpu_torch.nn.blocks import DBlockDeep, GBlockDeep
from gan3d_tpu_torch.nn.layers import Conv3d, Linear, SNConv3d, SNLinear
from gan3d_tpu_torch.nn.norm import BatchNorm3d

__all__ = ["BatchNorm3d", "Conv3d", "DBlockDeep", "GBlockDeep", "Linear",
           "SNConv3d", "SNLinear", "SelfAttention3d"]

"""Ops: pooling helpers, the pooled-attention op and its CUDA kernels."""

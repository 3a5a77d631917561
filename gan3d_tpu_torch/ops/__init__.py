"""Ops: pooling helpers, the pooled-attention op, the k3 convs and the
W-Toeplitz conv, with their CUDA kernels."""

"""gan3d_tpu_torch: the PyTorch / CUDA port of gan3d_tpu for NVIDIA Hopper.

A package of its own beside ``gan3d_tpu`` (the JAX reference, which it
never imports). Modules mirror the JAX package's layout. Layout is NCDHW;
the entry points run on the CUDA card unless the config asks for the CPU
(``platform="cpu"``). Every Pallas kernel of the JAX package has a
hand-written CUDA counterpart under ``csrc/`` (the pooled attention, the
k3 convs, the W-Toeplitz conv, the probe ladder), built with nvcc at
first use.
"""

"""gan3d_tpu_torch: the PyTorch / CUDA port of gan3d_tpu for NVIDIA Hopper.

A package of its own beside ``gan3d_tpu`` (the JAX reference, which it
never imports). Modules mirror the JAX package's layout. Layout is NCDHW;
the entry points run on the CUDA card unless the config asks for the CPU
(``platform="cpu"``). The pooled-attention kernels are hand-written CUDA
(``csrc/pooled_attention.cu``), built with nvcc at first use.
"""

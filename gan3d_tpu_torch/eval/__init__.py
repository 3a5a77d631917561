"""The evaluation stack (counterpart of gan3d_tpu/eval/): the metrics
(MMD, PSNR, MS-SSIM-3D, Fréchet distance, 3D-FID), the MedicalNet 3D
ResNet-50 and the Inception-V3 feature extractors, per-axis slice FID,
run loading with the sampler the CLIs use, and the export of a run to the
reference's on-disk layout. Volumes are NCDHW tensors on
the device; the math is f32. Only this package imports scipy (the
Fréchet distance's matrix square root, on the host)."""

from gan3d_tpu_torch.eval.metrics import (frechet_distance, mmd, ms_ssim_3d,
                                          psnr)

__all__ = ["mmd", "psnr", "ms_ssim_3d", "frechet_distance"]

"""Stabilization quality metrics and the in-training eval hook."""

from pwstablenet_tpu_torch.eval.metrics import (  # noqa: F401
    cropping_ratio_and_distortion,
    fidelity_report,
    psnr,
    ssim,
    stability_report,
    stability_score,
)

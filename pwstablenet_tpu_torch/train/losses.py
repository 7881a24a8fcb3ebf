"""Loss primitives and assembly, all computed in float32 whatever the
network's compute dtype.  The assembly mirrors the JAX package's
objective:

  total_G = adv + w_pixel * L1 + w_feature * perceptual
          + w_temporal * temporal + w_warp_reg * smoothness,

summed over cascade stages with normalized per-stage weights (later
stages higher).  Images are NHWC, flows (B, H, W, 2).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


# ---------------------------------------------------------------- GAN --

def gan_loss_d(
    real_logits: torch.Tensor, fake_logits: torch.Tensor, kind: str = "lsgan"
) -> torch.Tensor:
    """Discriminator objective on patch score maps."""
    real = _f32(real_logits)
    fake = _f32(fake_logits)
    if kind == "lsgan":
        return 0.5 * (torch.mean((real - 1.0) ** 2) + torch.mean(fake**2))
    if kind == "vanilla":
        return 0.5 * (
            torch.mean(_bce_with_logits(real, 1.0))
            + torch.mean(_bce_with_logits(fake, 0.0))
        )
    if kind == "hinge":
        return 0.5 * (
            torch.mean(F.relu(1.0 - real)) + torch.mean(F.relu(1.0 + fake))
        )
    raise ValueError(f"unknown gan loss {kind!r}")


def gan_loss_g(fake_logits: torch.Tensor, kind: str = "lsgan") -> torch.Tensor:
    """Generator adversarial objective (non-saturating)."""
    fake = _f32(fake_logits)
    if kind == "lsgan":
        return torch.mean((fake - 1.0) ** 2)
    if kind == "vanilla":
        return torch.mean(_bce_with_logits(fake, 1.0))
    if kind == "hinge":
        return -torch.mean(fake)
    raise ValueError(f"unknown gan loss {kind!r}")


def _bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    # numerically stable BCE-with-logits against a constant target
    return (
        torch.clamp(logits, min=0.0) - logits * target
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


# ------------------------------------------------------- reconstruction --

def pixel_loss_photometric(
    pred: torch.Tensor, target: torch.Tensor, mode: str = "l1"
) -> torch.Tensor:
    """Pixel loss with optional photometric invariance.

    - ``l1``: the plain reference loss.
    - ``mean_matched``: per-sample, per-channel multiplicative gain
      match in [0, 1] intensity space before the L1; the gain is
      detached (the generator cannot chase it) and clipped to [0.5, 2].
    - ``gradient``: L1 on spatial finite differences (invariant to a
      per-frame additive offset).
    """
    p = _f32(pred)
    t = _f32(target)
    if mode == "l1":
        return torch.mean(torch.abs(p - t))
    if mode == "mean_matched":
        p01 = (p + 1.0) * 0.5
        t01 = (t + 1.0) * 0.5
        dims = tuple(range(1, p01.ndim - 1))  # per sample, per channel
        gain = torch.mean(t01, dim=dims, keepdim=True) / (
            torch.mean(p01, dim=dims, keepdim=True) + 1e-4
        )
        gain = torch.clamp(gain, 0.5, 2.0).detach()
        return torch.mean(torch.abs(p01 * gain - t01)) * 2.0  # [-1, 1] scale
    if mode == "gradient":
        dy = (p[:, 1:] - p[:, :-1]) - (t[:, 1:] - t[:, :-1])
        dx = (p[:, :, 1:] - p[:, :, :-1]) - (t[:, :, 1:] - t[:, :, :-1])
        return torch.mean(torch.abs(dy)) + torch.mean(torch.abs(dx))
    raise ValueError(f"unknown pixel_loss_mode {mode!r}")


def feature_loss(
    feats_pred: Sequence[torch.Tensor], feats_target: Sequence[torch.Tensor]
) -> torch.Tensor:
    """Perceptual distance over a feature pyramid: the mean over scales
    of each scale's mean absolute difference."""
    total = torch.zeros((), dtype=torch.float32, device=feats_pred[0].device)
    for fp, ft in zip(feats_pred, feats_target):
        total = total + torch.mean(torch.abs(_f32(fp) - _f32(ft)))
    return total / max(len(feats_pred), 1)


# ------------------------------------------------------------ temporal --

def temporal_loss(stabilized_pair: torch.Tensor) -> torch.Tensor:
    """``stabilized_pair`` (B, 2, H, W, C): outputs for frames t and
    t+1 of one clip; penalizes their difference."""
    a = _f32(stabilized_pair[:, 0])
    b = _f32(stabilized_pair[:, 1])
    return torch.mean(torch.abs(a - b))


def temporal_loss_compensated(
    stabilized_pair: torch.Tensor, stable_pair: torch.Tensor
) -> torch.Tensor:
    """``|d(out) - d(gt)|`` with ``d(x) = x_{t+1} - x_t``: a pan present
    in both cancels, residual jitter does not."""
    d_out = _f32(stabilized_pair[:, 1]) - _f32(stabilized_pair[:, 0])
    d_gt = _f32(stable_pair[:, 1]) - _f32(stable_pair[:, 0])
    return torch.mean(torch.abs(d_out - d_gt))


# --------------------------------------------------- warp regularization --

def warp_smoothness_loss(flow: torch.Tensor) -> torch.Tensor:
    """Total-variation penalty on a (B, H, W, 2) warp field."""
    f = _f32(flow)
    dy = f[:, 1:, :, :] - f[:, :-1, :, :]
    dx = f[:, :, 1:, :] - f[:, :, :-1, :]
    return torch.mean(torch.abs(dy)) + torch.mean(torch.abs(dx))


def stage_weighted(
    per_stage: Sequence[torch.Tensor], weights: Sequence[float]
) -> torch.Tensor:
    """Weighted sum over cascade stages; the weights are normalized (in
    float32 on the host, so no host-to-device copy waits on the card)."""
    w = np.asarray(weights, np.float32)
    w = w / np.sum(w, dtype=np.float32)
    total = torch.zeros((), dtype=torch.float32, device=per_stage[0].device)
    for i, loss in enumerate(per_stage):
        total = total + float(w[i]) * loss
    return total

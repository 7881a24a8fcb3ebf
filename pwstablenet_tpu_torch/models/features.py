"""Feature extractor for the perceptual loss.

A small VGG-style conv pyramid, randomly initialised and FROZEN (the
JAX package's offline default): 3x3 SAME convs with ReLU, a float32
feature map per scale, then a 2x2 average pool.  Module names follow the
flax parameter tree (``conv{i}a``, ``conv{i}b``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pwstablenet_tpu_torch.config import ModelConfig
from pwstablenet_tpu_torch.models.blocks import conv2d, init_convs_


class FeatureExtractor(nn.Module):
    """NHWC (B, H, W, C) -> per-scale features, each NHWC float32."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = getattr(torch, cfg.compute_dtype)
        ch = cfg.in_channels
        for i, f in enumerate(cfg.feat_channels):
            self.add_module(f"conv{i}a", nn.Conv2d(ch, f, 3, 1, 1))
            self.add_module(f"conv{i}b", nn.Conv2d(f, f, 3, 1, 1))
            ch = f
        self.num_scales = len(cfg.feat_channels)
        init_convs_(self, generator)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)
        outs: List[torch.Tensor] = []
        for i in range(self.num_scales):
            x = F.relu(conv2d(getattr(self, f"conv{i}a"), x, dt))
            x = F.relu(conv2d(getattr(self, f"conv{i}b"), x, dt))
            outs.append(x.to(torch.float32).permute(0, 2, 3, 1))
            x = F.avg_pool2d(x, 2, 2)
        return outs

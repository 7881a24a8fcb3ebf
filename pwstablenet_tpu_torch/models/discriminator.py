"""PatchGAN discriminator.

A 70x70-receptive-field conv stack that scores real/fake patches,
conditioned on the input: the warped (or stable) frame is concatenated
with the unstable centre frame on channels, pix2pix-style.  The output
is an unnormalized per-patch score map; the GAN loss averages over
patches.  Module names follow the flax parameter tree (``conv{i}``,
``norm{i}``, ``score``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pwstablenet_tpu_torch.config import ModelConfig
from pwstablenet_tpu_torch.models.blocks import conv2d, init_convs_, make_norm


class PatchDiscriminator(nn.Module):
    """NHWC (B, H, W, 2C) -> per-patch scores (B, h, w, 1) float32; the
    input is the centre frame and a warped or stable frame, concatenated
    on channels."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        ch = 2 * cfg.in_channels
        f = cfg.disc_base_features
        for i in range(cfg.disc_num_layers + 1):
            stride = 2 if i < cfg.disc_num_layers else 1
            out = min(f * (2**i), 512)
            self.add_module(f"conv{i}", nn.Conv2d(ch, out, 4, stride, 1))
            if i > 0:
                norm = make_norm(cfg.disc_norm, out, self.dtype)
                if norm is not None:
                    self.add_module(f"norm{i}", norm)
            ch = out
        self.score = nn.Conv2d(ch, 1, 4, 1, 1)
        init_convs_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        # The final stride-1 4x4 pad-1 convs each shrink the map by 1;
        # too many stride-2 layers for the input leave an EMPTY score
        # map, whose mean is NaN: fail loudly instead.
        s = min(x.shape[1], x.shape[2])
        for _ in range(cfg.disc_num_layers):
            s = (s - 2) // 2 + 1
        if s - 2 < 1:
            raise ValueError(
                f"disc_num_layers={cfg.disc_num_layers} is too deep for "
                f"{x.shape[1]}x{x.shape[2]} inputs: the PatchGAN score "
                "map would be empty (NaN loss). Reduce disc_num_layers "
                "or raise the resolution."
            )
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(cfg.disc_num_layers + 1):
            x = conv2d(getattr(self, f"conv{i}"), x, self.dtype)
            norm = getattr(self, f"norm{i}", None)
            if norm is not None:
                x = norm(x)
            x = F.leaky_relu(x, 0.2)
        # per-patch score map, float32 for the loss
        x = conv2d(self.score, x.to(torch.float32), torch.float32)
        return x.permute(0, 2, 3, 1)

"""Stage UNet: one encoder-decoder stage of the cascaded generator.

Pix2pix-style topology: ``num_levels`` stride-2 downs (256x256 -> 1x1
at 8 levels), mirrored transpose-conv ups with intra-stage skip
concatenation, and a 2-channel warp head whose final conv is
zero-initialized, so a fresh stage is the identity warp.

Inter-stage wiring: the stage returns its decoder feature pyramid; a
later stage takes it through ``extra_skips``, each map concatenated
into the decoder input of matching resolution.

Module names follow the JAX package's parameter tree (``down{i}``,
``up{level}``, ``head_up``, ``head``), so ``interop/from_jax.py`` maps
one onto the other by name.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pwstablenet_tpu_torch.config import ModelConfig
from pwstablenet_tpu_torch.models.blocks import (
    DownBlock,
    UpBlock,
    conv2d,
    conv_transpose2d,
    lecun_normal_,
    make_deconv_2x,
)


def level_features(cfg: ModelConfig) -> List[int]:
    return [
        min(cfg.base_features * (2**i), cfg.max_features)
        for i in range(cfg.num_levels)
    ]


def decoder_channels(cfg: ModelConfig) -> List[int]:
    """Channels of a stage's decoder feature pyramid, coarse -> fine."""
    feats = level_features(cfg)
    return [feats[j - 1] for j in range(cfg.num_levels - 1, 0, -1)] + [
        cfg.base_features
    ]


class StageUNet(nn.Module):
    """One cascade stage: frame stack (+ optional context) -> warp field."""

    def __init__(self, cfg: ModelConfig, in_channels: int,
                 extra_skip_channels: Optional[Sequence[int]] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        L = cfg.num_levels
        feats = level_features(cfg)
        extra = list(extra_skip_channels or [])

        ch = in_channels
        for i, f in enumerate(feats):
            self.add_module(f"down{i}", DownBlock(
                ch, f, norm=cfg.norm, leaky_slope=cfg.leaky_slope,
                # pix2pix: no norm on the outermost and innermost level
                use_norm=0 < i < L - 1, dtype=self.dtype,
            ))
            ch = f

        for level, j in enumerate(range(L - 1, 0, -1)):
            cin = ch + (feats[j] if level > 0 else 0)
            if 0 < level <= len(extra):
                cin += extra[level - 1]
            self.add_module(f"up{level}", UpBlock(
                cin, feats[j - 1], norm=cfg.norm,
                dropout_rate=(
                    cfg.dropout_rate if cfg.use_dropout and level < 3 else 0.0
                ),
                dtype=self.dtype,
            ))
            ch = feats[j - 1]

        cin = ch + feats[0]
        if L - 1 <= len(extra):
            cin += extra[L - 2]
        self.head_up = make_deconv_2x(cin, cfg.base_features)
        head_in = cfg.base_features + (extra[L - 1] if len(extra) >= L else 0)
        self.head = nn.Conv2d(head_in, 2, 3, 1, 1)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """flax's initialisation: lecun-normal kernels, zero biases, unit
        norm scales, and a zero head (the identity warp)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.ConvTranspose2d):
                kh, kw = m.weight.shape[2:]
                lecun_normal_(m.weight, m.weight.shape[0] * kh * kw, generator)
                nn.init.zeros_(m.bias)
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def forward(
        self, x: torch.Tensor,
        extra_skips: Optional[Sequence[torch.Tensor]] = None,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x: (B, C, H, W).  Returns (flow (B, 2, H, W) float32 in
        normalized grid units, decoder features coarse -> fine).
        Dropout runs only with a ``dropout_generator``."""
        cfg = self.cfg
        dt = self.dtype
        L = cfg.num_levels
        x = x.to(dt)

        skips: List[torch.Tensor] = []
        for i in range(L):
            x = getattr(self, f"down{i}")(x)
            skips.append(x)

        decoder_feats: List[torch.Tensor] = []
        for level, j in enumerate(range(L - 1, 0, -1)):
            inputs = [x]
            if level > 0:
                inputs.append(skips[j])
            if extra_skips is not None and 0 < level <= len(extra_skips):
                inputs.append(extra_skips[level - 1].to(dt))
            x = torch.cat(inputs, dim=1) if len(inputs) > 1 else x
            x = getattr(self, f"up{level}")(x, dropout_generator)
            decoder_feats.append(x)

        inputs = [x, skips[0]]
        if extra_skips is not None and L - 1 <= len(extra_skips):
            inputs.append(extra_skips[L - 2].to(dt))
        x = F.relu(conv_transpose2d(self.head_up, torch.cat(inputs, dim=1), dt))
        if extra_skips is not None and len(extra_skips) >= L:
            x = torch.cat([x, extra_skips[L - 1].to(dt)], dim=1)
        decoder_feats.append(x)
        # the warp field is the precision-critical output: f32 head
        flow = conv2d(self.head, x, torch.float32)
        return flow * cfg.flow_scale, decoder_feats

"""Cascaded multi-stage generator.

Stage 1 maps the temporal frame stack to a coarse warp field; each
later stage refines it residually.  Stage k > 1 takes, per the
``interstage`` config:

- ``warped``:   the stack augmented with the previous stage's warped
                center frame and its flow field;
- ``features``: the previous stage's decoder feature pyramid via
                inter-stage skip connections;
- ``both``:     both of the above (default).

The inter-stage warp goes through ``ops.warp.warp_image_fused`` (the
f32 grid-sample kernel on the card).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from pwstablenet_tpu_torch.config import ModelConfig
from pwstablenet_tpu_torch.models.unet import StageUNet, decoder_channels
from pwstablenet_tpu_torch.ops.warp import warp_image_fused


class CascadedGenerator(nn.Module):
    """Frame stack (B, H, W, T*C) -> per-stage warp fields [(B, H, W, 2)]."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        for s in range(cfg.num_stages):
            cin = cfg.stack_channels
            extra = None
            if s > 0:
                if cfg.interstage in ("warped", "both"):
                    cin += cfg.in_channels + 2
                if cfg.interstage in ("features", "both"):
                    extra = decoder_channels(cfg)
            stage = StageUNet(cfg, cin, extra)
            stage.reset_parameters(generator)
            self.add_module(f"stage{s}", stage)

    def center_frame(self, stack: torch.Tensor) -> torch.Tensor:
        """The current frame of an NHWC temporal stack."""
        c0 = self.cfg.center_index * self.cfg.in_channels
        return stack[..., c0 : c0 + self.cfg.in_channels]

    def forward(
        self, stack: torch.Tensor,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> List[torch.Tensor]:
        """Dropout (``ModelConfig.use_dropout``) runs only when a
        ``dropout_generator`` on the stack's device is given."""
        cfg = self.cfg
        flows: List[torch.Tensor] = []
        x = stack
        feats = None
        for s in range(cfg.num_stages):
            extra = feats if (s > 0 and cfg.interstage in ("features", "both")) else None
            flow, feats = getattr(self, f"stage{s}")(
                x.permute(0, 3, 1, 2), extra, dropout_generator
            )
            flow = flow.permute(0, 2, 3, 1)
            if s > 0:
                flow = flows[-1] + flow  # residual refinement
            flows.append(flow)
            if s + 1 < cfg.num_stages and cfg.interstage in ("warped", "both"):
                warped = warp_image_fused(
                    self.center_frame(stack).to(torch.float32),
                    flow,
                    padding_mode=cfg.padding_mode,
                    align_corners=cfg.align_corners,
                )
                x = torch.cat(
                    [stack, warped.to(stack.dtype), flow.to(stack.dtype)],
                    dim=-1,
                )
            elif s + 1 < cfg.num_stages:
                x = stack
        return flows

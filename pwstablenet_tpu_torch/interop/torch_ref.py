"""The reference's PyTorch expression of the generator (parity oracle and
statement of the ``.pth`` layout).

The same cascaded generator as ``models.CascadedGenerator`` (topology,
norms, activations, padding, initialisation), written the way a PyTorch
reference checkpoint lays it out, NCHW:

- ``stages.{s}.downs.{i}`` (``Conv2d``) and ``stages.{s}.dnorms.{i}``
  (levels ``0 < i < num_levels - 1``; the others are ``Identity``);
- ``stages.{s}.ups.{l}`` (``ConvTranspose2d``) and
  ``stages.{s}.unorms.{l}``;
- ``stages.{s}.head_up`` (``ConvTranspose2d``) and ``stages.{s}.head``;
- ``convs.{k}`` for the feature extractor, two per scale.

``interop.torch_import`` maps this layout onto the port's module names.
The inter-stage warp here is ``F.grid_sample``, as in the reference's
oracle; nothing on the port's inference or training path runs this
module.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pwstablenet_tpu_torch.config import ModelConfig


def _norm(kind: str, ch: int) -> nn.Module:
    if kind == "instance":
        return nn.InstanceNorm2d(ch, affine=True, eps=1e-5)
    if kind == "batch":
        # stats-free (batch statistics at train and test time,
        # pix2pix-style): without running stats torch uses the batch's
        # statistics in eval mode too
        return nn.BatchNorm2d(ch, affine=True, eps=1e-5,
                              track_running_stats=False)
    if kind == "group":
        # flax GroupNorm(num_groups=8): contiguous channel groups, eps 1e-6
        return nn.GroupNorm(8, ch, eps=1e-6)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm kind {kind!r}")


class TorchStageUNet(nn.Module):
    """One stage, NCHW, in the reference's layout."""

    def __init__(self, cfg: ModelConfig, in_channels: int,
                 extra_skip_channels: Optional[List[int]] = None):
        super().__init__()
        self.cfg = cfg
        L = cfg.num_levels
        feats = [min(cfg.base_features * 2**i, cfg.max_features)
                 for i in range(L)]
        self.feats = feats
        self.extra = extra_skip_channels or []

        downs, dnorms = [], []
        ch = in_channels
        for i, f in enumerate(feats):
            downs.append(nn.Conv2d(ch, f, 4, 2, 1))
            dnorms.append(_norm(cfg.norm, f) if 0 < i < L - 1 else nn.Identity())
            ch = f
        self.downs = nn.ModuleList(downs)
        self.dnorms = nn.ModuleList(dnorms)

        ups, unorms = [], []
        ch = feats[-1]
        for level, j in enumerate(range(L - 1, 0, -1)):
            cin = ch
            if level > 0:
                cin += feats[j]
            if 0 < level <= len(self.extra):
                cin += self.extra[level - 1]
            ups.append(nn.ConvTranspose2d(cin, feats[j - 1], 4, 2, 1))
            unorms.append(_norm(cfg.norm, feats[j - 1]))
            ch = feats[j - 1]
        self.ups = nn.ModuleList(ups)
        self.unorms = nn.ModuleList(unorms)

        cin = ch + feats[0]
        if L - 1 <= len(self.extra):
            cin += self.extra[L - 2]
        self.head_up = nn.ConvTranspose2d(cin, cfg.base_features, 4, 2, 1)
        head_in = cfg.base_features
        if len(self.extra) >= L:
            head_in += self.extra[L - 1]
        self.head = nn.Conv2d(head_in, 2, 3, 1, 1)
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def forward(self, x, extra_skips=None):
        cfg = self.cfg
        L = cfg.num_levels
        skips = []
        for conv, norm in zip(self.downs, self.dnorms):
            x = F.leaky_relu(norm(conv(x)), cfg.leaky_slope)
            skips.append(x)

        dec_feats = []
        for level, j in enumerate(range(L - 1, 0, -1)):
            inputs = [x]
            if level > 0:
                inputs.append(skips[j])
            if extra_skips is not None and 0 < level <= len(extra_skips):
                inputs.append(extra_skips[level - 1])
            x = torch.cat(inputs, dim=1) if len(inputs) > 1 else x
            x = F.relu(self.unorms[level](self.ups[level](x)))
            dec_feats.append(x)

        inputs = [x, skips[0]]
        if extra_skips is not None and L - 1 <= len(extra_skips):
            inputs.append(extra_skips[L - 2])
        x = F.relu(self.head_up(torch.cat(inputs, dim=1)))
        if extra_skips is not None and len(extra_skips) >= L:
            x = torch.cat([x, extra_skips[L - 1]], dim=1)
        dec_feats.append(x)
        flow = self.head(x) * cfg.flow_scale
        return flow, dec_feats


class TorchFeatureExtractor(nn.Module):
    """The feature extractor, NCHW: two 3x3 conv+ReLU per scale, a 2x2
    average pool between scales, the feature map of every scale out."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        convs = []
        ch = cfg.in_channels
        for f in cfg.feat_channels:
            convs.append(nn.Conv2d(ch, f, 3, 1, 1))
            convs.append(nn.Conv2d(f, f, 3, 1, 1))
            ch = f
        self.convs = nn.ModuleList(convs)

    def forward(self, x):
        outs = []
        for i in range(0, len(self.convs), 2):
            x = F.relu(self.convs[i](x))
            x = F.relu(self.convs[i + 1](x))
            outs.append(x)
            x = F.avg_pool2d(x, 2, 2)
        return outs


def _torch_grid_sample_warp(frame, flow, cfg: ModelConfig):
    """Warp by a displacement in normalized grid units (NCHW)."""
    n, _, h, w = frame.shape
    ys = torch.linspace(-1, 1, h, device=frame.device)
    xs = torch.linspace(-1, 1, w, device=frame.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy], dim=-1)[None]
    grid = base + flow.permute(0, 2, 3, 1)
    return F.grid_sample(
        frame, grid, mode="bilinear",
        padding_mode=cfg.padding_mode,
        align_corners=cfg.align_corners,
    )


class TorchCascadedGenerator(nn.Module):
    """The cascaded generator, NCHW: (B, T*C, H, W) -> per-stage flows
    (B, 2, H, W)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        L = cfg.num_levels
        feats = [min(cfg.base_features * 2**i, cfg.max_features)
                 for i in range(L)]
        # stage 1's decoder pyramid channels, coarse -> fine
        dec_ch = [feats[j - 1] for j in range(L - 1, 0, -1)]
        dec_ch.append(cfg.base_features)  # head_up output

        stages = []
        for s in range(cfg.num_stages):
            cin = cfg.stack_channels
            extra = None
            if s > 0:
                if cfg.interstage in ("warped", "both"):
                    cin += cfg.in_channels + 2
                if cfg.interstage in ("features", "both"):
                    extra = dec_ch
            stages.append(TorchStageUNet(cfg, cin, extra))
        self.stages = nn.ModuleList(stages)

    def center_frame(self, stack):
        cfg = self.cfg
        c0 = cfg.center_index * cfg.in_channels
        return stack[:, c0 : c0 + cfg.in_channels]

    def forward(self, stack):
        cfg = self.cfg
        flows, x, feats = [], stack, None
        for s, stage in enumerate(self.stages):
            extra = feats if (s > 0 and cfg.interstage in ("features", "both")) else None
            flow, feats = stage(x, extra)
            if s > 0:
                flow = flows[-1] + flow
            flows.append(flow)
            if s + 1 < cfg.num_stages and cfg.interstage in ("warped", "both"):
                center = self.center_frame(stack)
                warped = _torch_grid_sample_warp(center, flow, cfg)
                x = torch.cat([stack, warped, flow], dim=1)
            elif s + 1 < cfg.num_stages:
                x = stack
        return flows

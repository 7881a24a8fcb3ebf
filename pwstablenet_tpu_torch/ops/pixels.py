"""Pixel-range conversion on the device.

Frames travel host<->device as uint8 and are normalized to [-1, 1] on
the device.  Float inputs pass through (cast), so every entry point
accepts either transport format.
"""

from __future__ import annotations

import torch


def to_unit(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 0..255 -> [-1, 1]; floating inputs pass through (cast)."""
    if not x.dtype.is_floating_point:
        return x.to(dtype) / 127.5 - 1.0
    return x.to(dtype)


def from_unit(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> uint8 0..255 (round half to even, saturating)."""
    y = torch.round((x.to(torch.float32) + 1.0) * 127.5)
    return torch.clamp(y, 0.0, 255.0).to(torch.uint8)

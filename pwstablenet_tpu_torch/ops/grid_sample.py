"""Bilinear / nearest grid sampling with exact
``torch.nn.functional.grid_sample`` semantics, in NHWC layout, written
out in plain tensor ops.

This is the port's CPU path and the oracle the CUDA kernels in
``kernels/grid_sample.py`` are held to.  It is written out rather than
calling ``F.grid_sample`` because it is also the kernels' plain version:
it repeats their arithmetic step for step.

Semantics:

- ``grid`` holds normalized coordinates in ``[-1, 1]``; ``grid[..., 0]``
  is x (width), ``grid[..., 1]`` is y (height).
- ``align_corners=True``: ``-1``/``+1`` map to the centers of the corner
  pixels; ``False``: to the corner pixels' outer edges.
- ``padding_mode``: ``zeros`` (out-of-bounds taps contribute 0),
  ``border`` (coordinates clamp to the edge), ``reflection``
  (coordinates reflect off the borders, then clamp).
"""

from __future__ import annotations

import torch

_PADDING_MODES = ("zeros", "border", "reflection")
_MODES = ("bilinear", "nearest")


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    """Map normalized [-1, 1] coordinates to pixel coordinates."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(coord: torch.Tensor, twice_low: float, twice_high: float) -> torch.Tensor:
    """Reflect coordinates into [twice_low/2, twice_high/2] (torch
    ``reflect_coordinates``)."""
    if twice_low == twice_high:
        return torch.zeros_like(coord)
    low = twice_low * 0.5
    span = (twice_high - twice_low) * 0.5
    coord = torch.abs(coord - low)
    extra = torch.remainder(coord, span)
    flips = torch.floor(coord / span)
    return torch.where(
        torch.remainder(flips, 2.0) == 0.0, extra + low, span - extra + low
    )


def _compute_source_index(
    coord: torch.Tensor, size: int, padding_mode: str, align_corners: bool
) -> torch.Tensor:
    """Normalized coord -> (possibly clipped/reflected) pixel coord."""
    coord = _unnormalize(coord, size, align_corners)
    if padding_mode == "border":
        coord = torch.clamp(coord, 0.0, size - 1)
    elif padding_mode == "reflection":
        if align_corners:
            coord = _reflect(coord, 0.0, 2.0 * (size - 1))
        else:
            coord = _reflect(coord, -1.0, 2.0 * size - 1.0)
        coord = torch.clamp(coord, 0.0, size - 1)
    return coord


def _gather(image: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """image (B, H, W, C), iy/ix (B, Ho, Wo) int64 in bounds -> (B, Ho, Wo, C)."""
    b, h, w, c = image.shape
    idx = (iy * w + ix).reshape(b, -1, 1).expand(-1, -1, c)
    out = torch.gather(image.reshape(b, h * w, c), 1, idx)
    return out.reshape(*iy.shape, c)


def grid_sample(
    image: torch.Tensor,
    grid: torch.Tensor,
    mode: str = "bilinear",
    padding_mode: str = "border",
    align_corners: bool = True,
) -> torch.Tensor:
    """Sample ``image (B, H, W, C)`` at ``grid (B, Ho, Wo, 2)``.

    Returns ``(B, Ho, Wo, C)`` with ``image``'s dtype; the arithmetic
    runs in float32 (or the grid's dtype, if wider)."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if padding_mode not in _PADDING_MODES:
        raise ValueError(
            f"padding_mode must be one of {_PADDING_MODES}, got {padding_mode!r}"
        )
    if image.ndim != 4 or grid.ndim != 4 or grid.shape[-1] != 2:
        raise ValueError(
            f"expected image (B,H,W,C) and grid (B,Ho,Wo,2); got "
            f"{tuple(image.shape)} and {tuple(grid.shape)}"
        )
    if not image.dtype.is_floating_point:
        raise ValueError(
            "grid_sample is the float oracle (output casts would truncate "
            "integers): normalize with ops.pixels.to_unit, or use "
            "ops.warp.warp_image, which handles uint8 end to end"
        )
    _, h, w, _ = image.shape
    compute_dtype = torch.promote_types(grid.dtype, torch.float32)
    gx = grid[..., 0].to(compute_dtype)
    gy = grid[..., 1].to(compute_dtype)
    x = _compute_source_index(gx, w, padding_mode, align_corners)
    y = _compute_source_index(gy, h, padding_mode, align_corners)

    if mode == "nearest":
        # torch rounds with nearbyint (half to even), as torch.round does
        ix = torch.round(x).to(torch.int64)
        iy = torch.round(y).to(torch.int64)
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        out = _gather(image, iy.clamp(0, h - 1), ix.clamp(0, w - 1))
        return torch.where(valid[..., None], out, torch.zeros_like(out))

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    def corner(yc, xc, wgt):
        iy = yc.to(torch.int64)
        ix = xc.to(torch.int64)
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        vals = _gather(image, iy.clamp(0, h - 1), ix.clamp(0, w - 1))
        wgt = torch.where(valid, wgt, torch.zeros_like(wgt))
        return vals.to(compute_dtype) * wgt[..., None]

    out = (
        corner(y0, x0, wy0 * wx0)
        + corner(y0, x1, wy0 * wx1)
        + corner(y1, x0, wy1 * wx0)
        + corner(y1, x1, wy1 * wx1)
    )
    return out.to(image.dtype)

"""Warp-field construction and application.

Conventions
-----------
The generator's warp head emits a displacement field ("flow")
``(B, H, W, 2)`` in normalized grid units: the sampling grid is
``identity_grid + flow``, where the identity grid spans ``[-1, 1]`` in
both axes (``flow[..., 0]`` displaces x, ``flow[..., 1]`` displaces y).
A zero flow is the identity warp.

The generator runs at a fixed model resolution while frames are
480p/720p/1080p, so flows are bilinearly resized to the frame
resolution before application; normalized units make the field
resolution-independent.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pwstablenet_tpu_torch.kernels.grid_sample import (
    grid_sample_f32,
    grid_sample_grad_f32,
    grid_sample_packed_u8,
)
from pwstablenet_tpu_torch.ops.pixels import from_unit, to_unit


def identity_grid(
    height: int,
    width: int,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """Normalized identity sampling grid ``(H, W, 2)``, last axis (x, y),
    in the ``align_corners=True`` convention (-1 and +1 are the centers
    of the edge pixels)."""
    ys = torch.linspace(-1.0, 1.0, height, dtype=dtype, device=device)
    xs = torch.linspace(-1.0, 1.0, width, dtype=dtype, device=device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([grid_x, grid_y], dim=-1)


def flow_to_grid(flow: torch.Tensor) -> torch.Tensor:
    """Displacement field ``(B, H, W, 2)`` -> absolute sampling grid."""
    _, h, w, _ = flow.shape
    return identity_grid(h, w, dtype=flow.dtype, device=flow.device)[None] + flow


def resize_flow(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinearly resize a normalized flow ``(B, h, w, 2)`` to
    ``(height, width)`` (half-pixel centers, no antialias).  Normalized
    units need no magnitude rescaling."""
    out = F.interpolate(
        flow.permute(0, 3, 1, 2),
        size=(height, width),
        mode="bilinear",
        align_corners=False,
        antialias=False,
    )
    return out.permute(0, 2, 3, 1)


def _grid(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if tuple(flow.shape[1:3]) != (h, w):
        flow = resize_flow(flow, h, w)
    return flow_to_grid(flow.to(torch.float32)).contiguous()


def warp_image(
    image: torch.Tensor,
    flow: torch.Tensor,
    padding_mode: str = "border",
    align_corners: bool = True,
) -> torch.Tensor:
    """Warp ``image (B, H, W, C)`` by displacement ``flow (B, h, w, 2)``.

    The flow is resized to the image resolution if needed and turned
    into an absolute grid.  uint8 RGB with border or reflection padding
    takes the packed uint8 kernel (uint8 in, uint8 out); any other
    integer image goes through ``to_unit``, the f32 kernel and
    ``from_unit``; a float image takes the f32 kernel and keeps its
    dtype."""
    _, h, w, c = image.shape
    grid = _grid(flow, h, w)
    if image.dtype == torch.uint8 and c == 3 and padding_mode in (
        "border", "reflection",
    ):
        return grid_sample_packed_u8(
            image.contiguous(), grid, padding_mode, align_corners
        )
    if not image.dtype.is_floating_point:
        out = grid_sample_f32(
            to_unit(image).contiguous(), grid, padding_mode, align_corners
        )
        return from_unit(out)
    out = grid_sample_f32(
        image.to(torch.float32).contiguous(), grid, padding_mode, align_corners
    )
    return out.to(image.dtype)


class _FusedSample(torch.autograd.Function):
    """f32 sample kernel forward, d/dgrid kernel backward (plain versions
    of both on CPU tensors).  The image gradient is zero by contract."""

    @staticmethod
    def forward(ctx, image, grid, padding_mode, align_corners):
        ctx.save_for_backward(image, grid)
        ctx.padding_mode = padding_mode
        ctx.align_corners = align_corners
        return grid_sample_f32(image, grid, padding_mode, align_corners)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[1]:
            return None, None, None, None
        image, grid = ctx.saved_tensors
        dgrid = grid_sample_grad_f32(
            image, grid, grad_out.to(torch.float32).contiguous(),
            ctx.padding_mode, ctx.align_corners,
        )
        return None, dgrid, None, None


def warp_image_fused(
    image: torch.Tensor,
    flow: torch.Tensor,
    padding_mode: str = "border",
    align_corners: bool = True,
) -> torch.Tensor:
    """The cascade's warp: the image is data (detached; its gradient is
    defined as zero), the flow is the differentiable input.  Returns
    f32."""
    _, h, w, _ = image.shape
    grid = _grid(flow, h, w)
    image = image.detach().to(torch.float32).contiguous()
    return _FusedSample.apply(image, grid, padding_mode, align_corners)

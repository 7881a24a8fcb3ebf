"""Pixel conversion, plain grid sample and warps."""

from pwstablenet_tpu_torch.ops.grid_sample import grid_sample  # noqa: F401
from pwstablenet_tpu_torch.ops.warp import (  # noqa: F401
    flow_to_grid,
    identity_grid,
    resize_flow,
    warp_image,
    warp_image_fused,
)

"""Row-sharded warping: one very large frame (4K/8K stills or mural
video) warped by the ranks of a mesh together.

Clip-sharded inference (``pipeline.Stabilizer(mesh=...)``) spreads
independent temporal windows over the ranks; this module spreads the
per-frame warp itself by sharding the image rows:

- each rank holds a contiguous row band of the frame and of the flow;
- stabilization warps displace vertically by at most ``halo`` rows
  (default 120), so each rank needs only ``halo`` rows from each
  neighbour: two point-to-point halo exchanges, no all-gather;
- the normalized grid is clamped to the frame's border in global rows,
  then remapped into the rank's extended local frame, where the port's
  kernels sample locally (``grid_sample_f32``, or
  ``grid_sample_packed_u8`` for uint8 RGB; their plain versions for CPU
  tensors).

Padding modes: ``border`` and ``reflection`` (reflection is applied as
a pre-reflection of the global grid, after which border semantics are
exact).  ``zeros`` would need per-tap global validity inside the
kernel; callers use the unsharded path for it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pwstablenet_tpu_torch.kernels.grid_sample import (
    _reflect_grid,
    grid_sample_f32,
    grid_sample_packed_u8,
)
from pwstablenet_tpu_torch.parallel.mesh import Mesh

_DEFAULT_HALO = 120  # rows


def _band_grid(flow_band: torch.Tensor, h: int, w: int, row0: int) -> torch.Tensor:
    """The absolute grid of a band of global rows ``[row0, row0+hs)``:
    the same values as those rows of ``ops.warp.flow_to_grid`` of the
    whole flow."""
    hs = flow_band.shape[1]
    dev = flow_band.device
    ys = torch.linspace(-1.0, 1.0, h, device=dev)[row0 : row0 + hs]
    xs = torch.linspace(-1.0, 1.0, w, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None] + flow_band.to(torch.float32)


def _exchange_halo(band: torch.Tensor, halo: int, mesh: Mesh):
    """(the ``halo`` rows above the band, the ``halo`` rows below it),
    from the neighbouring ranks; zeros at the frame's top and bottom
    edges, which the border clamp keeps from being sampled.

    Gloo sends and receives host tensors only: on a gloo group, CUDA
    bands travel through pinned host buffers (the transport; the sample
    stays on the card).  NCCL moves the CUDA tensors themselves."""
    r, n = mesh.rank, mesh.size
    above = torch.zeros_like(band[:, :halo])
    below = torch.zeros_like(band[:, :halo])
    if n == 1:
        return above, below
    staged = band.is_cuda and dist.get_backend(mesh.group) == "gloo"

    def wire(t):
        if not staged:
            return t.contiguous()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)

    recv_above, recv_below = wire(above), wire(below)
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, wire(band[:, :halo]), r - 1, mesh.group),
                dist.P2POp(dist.irecv, recv_above, r - 1, mesh.group)]
    if r < n - 1:
        ops += [dist.P2POp(dist.isend, wire(band[:, -halo:]), r + 1, mesh.group),
                dist.P2POp(dist.irecv, recv_below, r + 1, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv_above.to(band.device), recv_below.to(band.device)


def spatial_sharded_warp(
    image: torch.Tensor,
    flow: torch.Tensor,
    mesh: Mesh,
    halo: int = _DEFAULT_HALO,
    padding_mode: str = "border",
    align_corners: bool = True,
) -> torch.Tensor:
    """Warp ``image (B, H, W, C)`` by ``flow (B, H, W, 2)`` with rows
    sharded over ``mesh``: this rank takes rows ``[r*H/n, (r+1)*H/n)``
    of both, exchanges halos with its neighbours, and returns its band
    of the warped image, ``(B, H/n, W, C)`` in the image's dtype.
    Vertical displacement must stay within ``halo`` rows (the
    stabilization contract); horizontal is unsharded.  Every rank of the
    mesh calls it with the same arguments."""
    n = mesh.size
    b, h, w, c = image.shape
    if h % n:
        raise ValueError(f"H={h} must divide over {n} mesh ranks")
    if padding_mode not in ("border", "reflection"):
        raise ValueError(
            "spatial_sharded_warp supports border/reflection; use the "
            "unsharded path for zeros"
        )
    hs = h // n
    if halo > hs:
        raise ValueError(f"halo ({halo}) exceeds shard height ({hs})")
    row0 = mesh.rank * hs
    band = image[:, row0 : row0 + hs]
    if image.dtype != torch.uint8:
        band = band.to(torch.float32)
    grid = _band_grid(flow[:, row0 : row0 + hs], h, w, row0)
    if padding_mode == "reflection":
        grid = _reflect_grid(grid, h, w, align_corners)[0]

    above, below = _exchange_halo(band, halo, mesh)
    ext = torch.cat([above, band, below], dim=1)
    h_ext = hs + 2 * halo

    # global normalized y -> global pixel row -> the extended local frame
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        y_px = (gy + 1.0) * 0.5 * (h - 1)
    else:
        y_px = ((gy + 1.0) * h - 1.0) * 0.5
    # the global border clamp: the only clamp that may touch the frame's
    # edges (a clamp local to the band would corrupt the seams)
    y_loc = torch.clamp(y_px, 0.0, h - 1) - float(row0 - halo)
    if align_corners:
        gy_loc = y_loc / (0.5 * (h_ext - 1)) - 1.0
    else:
        gy_loc = (2.0 * y_loc + 1.0) / h_ext - 1.0
    grid_loc = torch.stack([gx, gy_loc], dim=-1).contiguous()
    if ext.dtype == torch.uint8:
        return grid_sample_packed_u8(ext, grid_loc, "border", align_corners)
    return grid_sample_f32(ext, grid_loc, "border", align_corners).to(image.dtype)

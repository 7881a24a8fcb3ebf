"""Hand-written CUDA grid-sample kernels, their wrappers and their plain
PyTorch versions.

Three kernels (``csrc/grid_sample.cu``) replace the Pallas TPU kernels
of ``pwstablenet_tpu/kernels/grid_sample_pallas.py``:

- ``grid_sample_f32`` (replaces ``grid_sample_pallas``): NHWC f32 image,
  f32 grid, border or zeros padding, either ``align_corners``.
- ``grid_sample_packed_u8`` (replaces ``grid_sample_pallas_packed``):
  uint8 RGB in, uint8 RGB out, border padding; each channel blends in
  f32 on the 0..255 scale, rounds half to even and saturates.
- ``grid_sample_grad_f32`` (replaces ``grid_sample_grad_pallas``):
  d/dgrid of ``sum(cot * grid_sample_f32(image, grid))``, the backward
  of ``ops.warp.warp_image_fused``; no image gradient.

Reflection padding is a grid pre-reflection (``_reflect_grid``)
followed by a border sample, for all three kernels; the gradient is
then multiplied by the reflection's sign ``dsign``.

All three kernels are designed for the H100, where the instructions and
the loads in flight around each byte, more than device memory, hold a
gather back (the header of ``csrc/grid_sample.cu`` has the whole design
and ``PERF.md`` what each step bought).  Each launches a 3-D grid
(column groups, rows, batch) and indexes a frame in 32 bits; each reads
the grid (and the cotangent) and writes the output with evict-first
hints, and gathers taps through the read-only path.

- ``grid_sample_f32``: one thread per output pixel, so a warp's loads
  cover neighbouring pixels; for RGB, each tap row pair (6 adjacent
  floats) comes in 8-byte loads, 6-8 a pixel instead of 12 float loads.
- ``grid_sample_packed_u8``: four adjacent pixels a thread, their grid
  entries in two 16-byte loads and their 12 output bytes in three 4-byte
  stores; each tap row pair (6 adjacent bytes) comes in one or two
  aligned 8-byte loads, 2-4 a pixel instead of 12 byte loads; registers
  capped at 32, so that eight blocks fit on each SM.
- ``grid_sample_grad_f32``: one thread per output pixel, as the f32
  sample; for RGB, the tap row pairs in 8-byte loads and the 12
  cotangent bytes as an 8-byte and a 4-byte load, 9-11 loads a pixel
  instead of 16.

Where a packed group of pixels is not whole (a row's head or tail) or
an address is not aligned (an image, grid or output that is a view at
an odd offset, a row width that is no multiple of the group), the kernel
takes its per-pixel path for that group: same arithmetic, scalar loads
and stores; the f32 and d/dgrid kernels load an unaligned grid entry as
two floats, and d/dgrid an RGB cotangent that starts off an 8-byte
boundary as a float and then a float2.  Any displacement is exact; any
``Ho x Wo`` is taken, up to 65535 frames and 524280 rows (the 3-D
launch's limits).

Each wrapper runs its plain version when the tensors lie on the CPU,
and launches its kernel on a CUDA tensor: there is no fallback between
the two.  ``LAUNCHES`` counts kernel launches per kernel; the plain
versions do not count.

The two forward kernels are PyTorch operators, ``pwst::grid_sample_f32``
and ``pwst::grid_sample_packed_u8`` (``torch.library.custom_op``), each
with a CPU implementation (the plain arithmetic), a CUDA implementation
(the launch) and a fake one (the output's shape and dtype).  The device
is chosen by the dispatcher when the operator runs, so a program that
``torch.export`` traced holds one call node per operator and launches
the kernel whenever it runs on the card.  The wrappers check their
inputs and pre-reflect the grid (``_reflect_grid``, plain tensor ops
that an export traces) before the operator, which samples with border
or zeros padding only.  ``grid_sample_grad_f32`` is called only from
``ops.warp._FusedSample.backward`` and stays a plain function.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pwstablenet_tpu_torch.kernels._build import library
from pwstablenet_tpu_torch.ops.grid_sample import _gather, _unnormalize
from pwstablenet_tpu_torch.ops.grid_sample import grid_sample as _oracle

LAUNCHES = {
    "grid_sample_f32": 0, "grid_sample_packed_u8": 0, "grid_sample_grad_f32": 0,
}

# what the C interface of every kernel refuses with CUDA error 1: a frame
# that does not index in 32 bits, and more frames or rows than the 3-D
# launch takes
_LAUNCH_LIMITS = "H*W*C < 2^31, B <= 65535 and Ho <= 524280"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` through its C entry point ``pwst_<name>`` on
    ``device``'s current stream and count it; raise if it was refused."""
    err = getattr(library(), f"pwst_{name}")(
        *args, torch.cuda.current_stream(device).cuda_stream
    )
    if err:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} (limits: {_LAUNCH_LIMITS})"
        )
    LAUNCHES[name] += 1


def _reflect_grid(
    grid: torch.Tensor, h: int, w: int, align_corners: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-reflect a normalized grid into in-bounds coordinates (torch
    ``reflection`` padding), returning ``(reflected_grid, dsign)``.

    After reflection and clip the coordinates lie in ``[0, size-1]``, so
    a ``border`` sample of the reflected grid has ``reflection``
    semantics.  ``dsign`` is d(reflected)/d(original) in {-1, 0, +1},
    for the gradient of the training slice."""
    outs, signs = [], []
    for axis, size in ((0, w), (1, h)):
        g = grid[..., axis].to(torch.float32)
        if size == 1:
            outs.append(torch.full_like(g, -1.0))
            signs.append(torch.zeros_like(g))
            continue
        if align_corners:
            scale = 0.5 * (size - 1)
            x = (g + 1.0) * scale
            low, span = 0.0, float(size - 1)
        else:
            scale = 0.5 * size
            x = (g + 1.0) * scale - 0.5
            low, span = -0.5, float(size)
        d = x - low
        s1 = torch.where(d >= 0.0, 1.0, -1.0)
        a = torch.abs(d)
        extra = torch.remainder(a, span)
        even = torch.remainder(torch.floor(a / span), 2.0) == 0.0
        xr = torch.where(even, extra + low, span - extra + low)
        s2 = torch.where(even, 1.0, -1.0)
        inb = (xr >= 0.0) & (xr <= size - 1)
        xrc = torch.clamp(xr, 0.0, size - 1)
        if align_corners:
            gr = xrc / scale - 1.0
        else:
            gr = (xrc + 0.5) / scale - 1.0
        outs.append(gr)
        signs.append(s1 * s2 * inb.to(torch.float32))
    return torch.stack(outs, dim=-1), torch.stack(signs, dim=-1)


def _border_grid(grid, h, w, padding_mode, align_corners, allowed):
    if padding_mode not in allowed:
        raise ValueError(
            f"padding_mode must be one of {allowed}, got {padding_mode!r}"
        )
    if padding_mode == "reflection":
        return _reflect_grid(grid, h, w, align_corners)[0], "border"
    return grid, padding_mode


def _check_devices(image: torch.Tensor, grid: torch.Tensor) -> None:
    """Raise unless both tensors lie on the CPU or on one CUDA device."""
    if image.device.type == "cpu" and grid.device.type == "cpu":
        return
    if image.device.type == "cuda" and image.device == grid.device:
        return
    raise ValueError(
        f"image and grid must both lie on the CPU or on one CUDA "
        f"device; got {image.device} and {grid.device}"
    )


def _on_cpu(image: torch.Tensor, grid: torch.Tensor) -> bool:
    """True for CPU tensors; CUDA tensors return False; anything else
    (mixed devices, other device types) raises."""
    _check_devices(image, grid)
    return image.device.type == "cpu"


def _check(image, grid, dtype, channels=None):
    if image.dtype != dtype:
        raise ValueError(f"image must be {dtype}, got {image.dtype}")
    if grid.dtype != torch.float32:
        raise ValueError(f"grid must be float32, got {grid.dtype}")
    if image.ndim != 4 or grid.ndim != 4 or grid.shape[-1] != 2:
        raise ValueError(
            f"expected image (B,H,W,C) and grid (B,Ho,Wo,2); got "
            f"{tuple(image.shape)} and {tuple(grid.shape)}"
        )
    if grid.shape[0] != image.shape[0]:
        raise ValueError("image and grid batch sizes differ")
    if channels is not None and image.shape[-1] != channels:
        raise ValueError(f"image must have {channels} channels")


def _check_contiguous(*tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


# ---------------------------------------------------------------------
# f32 sample
# ---------------------------------------------------------------------


def grid_sample_f32_plain(image, grid, padding_mode="border", align_corners=True):
    """Plain version of ``grid_sample_f32``: the same pre-reflection and
    the oracle's bilinear arithmetic."""
    _, h, w, _ = image.shape
    grid, mode = _border_grid(
        grid, h, w, padding_mode, align_corners,
        ("border", "zeros", "reflection"),
    )
    return _oracle(image, grid, "bilinear", mode, align_corners)


def _f32_cpu(image: torch.Tensor, grid: torch.Tensor, zeros: bool,
             align_corners: bool) -> torch.Tensor:
    return _oracle(image, grid, "bilinear", "zeros" if zeros else "border",
                   align_corners)


def _f32_cuda(image: torch.Tensor, grid: torch.Tensor, zeros: bool,
              align_corners: bool) -> torch.Tensor:
    _check_contiguous(image, grid)
    b, h, w, c = image.shape
    _, ho, wo, _ = grid.shape
    out = torch.empty((b, ho, wo, c), dtype=torch.float32, device=image.device)
    _launch(
        "grid_sample_f32", image.device, image.data_ptr(), grid.data_ptr(), out.data_ptr(),
        b, h, w, c, ho, wo, int(zeros), int(align_corners),
    )
    return out


def _f32_fake(image, grid, zeros, align_corners):
    return image.new_empty((image.shape[0], grid.shape[1], grid.shape[2], image.shape[3]))


_f32_op = torch.library.custom_op(
    "pwst::grid_sample_f32", _f32_cpu, mutates_args=(), device_types="cpu",
    schema="(Tensor image, Tensor grid, bool zeros, bool align_corners) -> Tensor",
)
_f32_op.register_kernel("cuda", _f32_cuda)
_f32_op.register_fake(_f32_fake)


def grid_sample_f32(image, grid, padding_mode="border", align_corners=True):
    """Bilinear sample: image (B,H,W,C) f32, grid (B,Ho,Wo,2) f32 ->
    (B,Ho,Wo,C) f32."""
    _check(image, grid, torch.float32)
    _check_devices(image, grid)
    _, h, w, _ = image.shape
    grid, mode = _border_grid(
        grid, h, w, padding_mode, align_corners,
        ("border", "zeros", "reflection"),
    )
    return torch.ops.pwst.grid_sample_f32(image, grid, mode == "zeros", bool(align_corners))


# ---------------------------------------------------------------------
# packed uint8 RGB sample
# ---------------------------------------------------------------------


def grid_sample_packed_u8_plain(image, grid, padding_mode="border", align_corners=True):
    """Plain version of ``grid_sample_packed_u8``, step for step."""
    _, h, w, _ = image.shape
    grid, _ = _border_grid(
        grid, h, w, padding_mode, align_corners, ("border", "reflection")
    )
    return _packed_u8_cpu(image, grid, align_corners)


def _packed_u8_cpu(image: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool) -> torch.Tensor:
    _, h, w, _ = image.shape
    x = torch.clamp(_unnormalize(grid[..., 0], w, align_corners), 0.0, w - 1)
    y = torch.clamp(_unnormalize(grid[..., 1], h, align_corners), 0.0, h - 1)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)

    def tap(iy, ix):
        return _gather(image, iy, ix).to(torch.float32)

    v = (1.0 - fy) * (1.0 - fx) * tap(y0, x0)
    v = v + (1.0 - fy) * fx * tap(y0, x1)
    v = v + fy * (1.0 - fx) * tap(y1, x0)
    v = v + fy * fx * tap(y1, x1)
    return torch.clamp(torch.round(v), 0.0, 255.0).to(torch.uint8)


def _packed_u8_cuda(image: torch.Tensor, grid: torch.Tensor,
                    align_corners: bool) -> torch.Tensor:
    _check_contiguous(image, grid)
    b, h, w, _ = image.shape
    _, ho, wo, _ = grid.shape
    out = torch.empty((b, ho, wo, 3), dtype=torch.uint8, device=image.device)
    _launch(
        "grid_sample_packed_u8", image.device, image.data_ptr(), grid.data_ptr(),
        out.data_ptr(), b, h, w, ho, wo, int(align_corners),
    )
    return out


def _packed_u8_fake(image, grid, align_corners):
    return image.new_empty((image.shape[0], grid.shape[1], grid.shape[2], 3))


_packed_u8_op = torch.library.custom_op(
    "pwst::grid_sample_packed_u8", _packed_u8_cpu, mutates_args=(), device_types="cpu",
    schema="(Tensor image, Tensor grid, bool align_corners) -> Tensor",
)
_packed_u8_op.register_kernel("cuda", _packed_u8_cuda)
_packed_u8_op.register_fake(_packed_u8_fake)


def grid_sample_packed_u8(image, grid, padding_mode="border", align_corners=True):
    """uint8 RGB sample: image (B,H,W,3) uint8, grid (B,Ho,Wo,2) f32 ->
    (B,Ho,Wo,3) uint8; border or reflection padding."""
    _check(image, grid, torch.uint8, channels=3)
    _check_devices(image, grid)
    _, h, w, _ = image.shape
    grid, _ = _border_grid(
        grid, h, w, padding_mode, align_corners, ("border", "reflection")
    )
    return torch.ops.pwst.grid_sample_packed_u8(image, grid, bool(align_corners))


# ---------------------------------------------------------------------
# d/dgrid of the f32 sample
# ---------------------------------------------------------------------


def _check_cot(cot, image, grid):
    if cot.dtype != torch.float32:
        raise ValueError(f"cotangent must be float32, got {cot.dtype}")
    expect = (*grid.shape[:-1], image.shape[-1])
    if tuple(cot.shape) != expect:
        raise ValueError(
            f"cotangent must have shape {expect}, got {tuple(cot.shape)}"
        )
    if cot.device != grid.device:
        raise ValueError("cotangent and grid lie on different devices")


def _grad_grid(grid, h, w, padding_mode, align_corners):
    """(grid to differentiate at, its padding mode, dsign or None)."""
    if padding_mode not in ("border", "zeros", "reflection"):
        raise ValueError(
            f"padding_mode must be one of ('border', 'zeros', 'reflection'), "
            f"got {padding_mode!r}"
        )
    if padding_mode == "reflection":
        rgrid, dsign = _reflect_grid(grid, h, w, align_corners)
        return rgrid.contiguous(), "border", dsign
    return grid, padding_mode, None


def grid_sample_grad_f32_plain(
    image, grid, cot, padding_mode="border", align_corners=True
):
    """Plain version of ``grid_sample_grad_f32``: the kernel's steps in
    tensor ops, in its order (not autograd of the sampler).

    The semantics are the TPU kernel's: taps are clamped into the image
    and masked per corner in ``zeros`` mode; in ``border`` mode the tap
    row below the last row reads 0 and the gradient is zeroed where the
    unclipped coordinate lies outside the closed ``[0, size-1]`` (kept
    on the boundary itself)."""
    _, h, w, c = image.shape
    grid, mode, dsign = _grad_grid(grid, h, w, padding_mode, align_corners)
    zeros = mode == "zeros"
    ux = _unnormalize(grid[..., 0], w, align_corners)
    uy = _unnormalize(grid[..., 1], h, align_corners)
    x, y = ux, uy
    if not zeros:
        x = torch.clamp(x, 0.0, w - 1)
        y = torch.clamp(y, 0.0, h - 1)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x1 = x0 + 1
    y1 = y0 + 1
    vx0, vx1 = (x0 >= 0) & (x0 < w), (x1 >= 0) & (x1 < w)
    vy0, vy1 = (y0 >= 0) & (y0 < h), (y1 >= 0) & (y1 < h)
    if zeros:
        masks = (vy0 & vx0, vy0 & vx1, vy1 & vx0, vy1 & vx1)
    else:
        masks = (None, None, vy1, vy1)
    taps = []
    for (iy, ix), m in zip(((y0, x0), (y0, x1), (y1, x0), (y1, x1)), masks):
        a = _gather(image, iy.clamp(0, h - 1), ix.clamp(0, w - 1))
        if m is not None:
            a = torch.where(m[..., None], a, torch.zeros_like(a))
        taps.append(a)
    a00, a01, a10, a11 = taps
    dgx = torch.zeros_like(fx)
    dgy = torch.zeros_like(fy)
    for ch in range(c):
        gc = cot[..., ch]
        dgx = dgx + gc * ((1.0 - fy) * (a01[..., ch] - a00[..., ch])
                          + fy * (a11[..., ch] - a10[..., ch]))
        dgy = dgy + gc * ((1.0 - fx) * (a10[..., ch] - a00[..., ch])
                          + fx * (a11[..., ch] - a01[..., ch]))
    if not zeros:
        dgx = torch.where((ux >= 0.0) & (ux <= w - 1), dgx, torch.zeros_like(dgx))
        dgy = torch.where((uy >= 0.0) & (uy <= h - 1), dgy, torch.zeros_like(dgy))
    sx, sy = (0.5 * (w - 1), 0.5 * (h - 1)) if align_corners else (0.5 * w, 0.5 * h)
    out = torch.stack([dgx * sx, dgy * sy], dim=-1)
    return out if dsign is None else out * dsign


def grid_sample_grad_f32(image, grid, cot, padding_mode="border", align_corners=True):
    """d/dgrid of ``sum(cot * grid_sample_f32(image, grid))``: image
    (B,H,W,C) f32, grid (B,Ho,Wo,2) f32, cot (B,Ho,Wo,C) f32 ->
    (B,Ho,Wo,2) f32."""
    _check(image, grid, torch.float32)
    _check_cot(cot, image, grid)
    if _on_cpu(image, grid):
        return grid_sample_grad_f32_plain(image, grid, cot, padding_mode, align_corners)
    b, h, w, c = image.shape
    _, ho, wo, _ = grid.shape
    grid, mode, dsign = _grad_grid(grid, h, w, padding_mode, align_corners)
    _check_contiguous(image, grid, cot)
    out = torch.empty((b, ho, wo, 2), dtype=torch.float32, device=image.device)
    _launch(
        "grid_sample_grad_f32", image.device, image.data_ptr(), grid.data_ptr(),
        cot.data_ptr(), out.data_ptr(),
        b, h, w, c, ho, wo, int(mode == "zeros"), int(bool(align_corners)),
    )
    return out if dsign is None else out * dsign

"""Conv building blocks of the generator, NCHW inside.

Pix2pix-style stride-2 encoder and transpose-conv decoder blocks.
Activations run in the compute dtype (bfloat16 by default) with float32
parameters, as flax's ``dtype=`` does it: each conv casts its input,
weight and bias to the compute dtype; norm statistics are computed in
float32 and the result is cast back.  No ``autocast``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F


def lecun_normal_(
    weight: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]
) -> None:
    """flax's default kernel init: truncated normal (+-2 sigma) with
    variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def init_convs_(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """flax's initialisation of every ``nn.Conv2d`` below ``module``:
    lecun-normal kernels and zero biases (norm scales start at 1, biases
    at 0)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            nn.init.zeros_(m.bias)


def conv2d(m: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(
        x.to(dtype), m.weight.to(dtype), m.bias.to(dtype), m.stride, m.padding
    )


def conv_transpose2d(
    m: nn.ConvTranspose2d, x: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    return F.conv_transpose2d(
        x.to(dtype), m.weight.to(dtype), m.bias.to(dtype), m.stride, m.padding
    )


class _Norm(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dtype = dtype
        self.eps = eps

    def _affine(self, y: torch.Tensor) -> torch.Tensor:
        return (y * self.weight[:, None, None] + self.bias[:, None, None]).to(
            self.dtype
        )


class InstanceNorm(_Norm):
    """Per-sample, per-channel spatial normalization with one-pass
    float32 statistics: var = max(E[x^2] - E[x]^2, 0)."""

    def __init__(self, channels: int, dtype: torch.dtype, eps: float = 1e-5):
        super().__init__(channels, dtype, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mu = xf.mean(dim=(2, 3), keepdim=True)
        ex2 = xf.square().mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(ex2 - mu.square(), min=0.0)
        return self._affine((xf - mu) * torch.rsqrt(var + self.eps))


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group, forward and backward: the backward sums
    the incoming gradients, which is the gradient of statistics taken
    over the global batch (what the reference's SPMD partitioner derives
    for a mean over a sharded axis)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm(_Norm):
    """Stats-free batch normalization: batch statistics at train and
    test time (pix2pix), two-pass, in float32.

    With a process group in ``group`` (``parallel.mesh.sync_batch_norm``)
    the statistics are the global batch's: each pass all-reduces its
    per-channel sum and element count over the group."""

    def __init__(self, channels: int, dtype: torch.dtype, eps: float = 1e-5):
        super().__init__(channels, dtype, eps)
        self.group = None

    def _mean(self, t: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return t.mean(dim=(0, 2, 3), keepdim=True)
        local = torch.cat([t.sum(dim=(0, 2, 3)), t.new_full((1,), t.numel() / t.shape[1])])
        total = _AllReduceSum.apply(local, self.group)
        return (total[:-1] / total[-1])[None, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mu = self._mean(xf)
        var = self._mean((xf - mu).square())
        return self._affine((xf - mu) * torch.rsqrt(var + self.eps))


class GroupNorm(_Norm):
    """flax ``GroupNorm(num_groups=8)``: contiguous channel groups,
    one-pass float32 statistics clamped at 0, eps 1e-6."""

    def __init__(self, channels: int, dtype: torch.dtype,
                 num_groups: int = 8, eps: float = 1e-6):
        super().__init__(channels, dtype, eps)
        self.num_groups = num_groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        xf = x.to(torch.float32).reshape(n, self.num_groups, c // self.num_groups, h, w)
        mu = xf.mean(dim=(2, 3, 4), keepdim=True)
        ex2 = xf.square().mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp(ex2 - mu.square(), min=0.0)
        y = ((xf - mu) * torch.rsqrt(var + self.eps)).reshape(n, c, h, w)
        return self._affine(y)


def make_norm(kind: str, channels: int, dtype: torch.dtype) -> Optional[nn.Module]:
    """Normalization factory: batch | instance | group | none (None)."""
    if kind == "none":
        return None
    if kind == "instance":
        return InstanceNorm(channels, dtype)
    if kind == "group":
        return GroupNorm(channels, dtype)
    if kind == "batch":
        return BatchNorm(channels, dtype)
    raise ValueError(f"unknown norm kind {kind!r}")


def make_deconv_2x(in_channels: int, features: int) -> nn.ConvTranspose2d:
    """The decoder's exact 2x upsampler (stride-2 4x4 transposed conv).
    Serves both ``decoder_impl`` values: they share one parameter tree
    and one operator."""
    return nn.ConvTranspose2d(in_channels, features, 4, 2, 1)


class DownBlock(nn.Module):
    """Stride-2 4x4 conv -> norm -> LeakyReLU."""

    def __init__(self, in_channels: int, features: int, norm: str = "instance",
                 leaky_slope: float = 0.2, use_norm: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, 4, 2, 1)
        self.norm = make_norm(norm, features, dtype) if use_norm else None
        self.leaky_slope = leaky_slope
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(self.conv, x, self.dtype)
        if self.norm is not None:
            x = self.norm(x)
        return F.leaky_relu(x, self.leaky_slope)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale
    by ``1 / (1 - rate)``.  The mask is drawn from ``generator`` (on
    ``x``'s device), never from the global RNG."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class UpBlock(nn.Module):
    """Stride-2 4x4 transposed conv -> norm -> (dropout) -> ReLU.

    Dropout runs only when the caller passes a ``generator`` (the train
    step does), as flax's runs only when ``deterministic=False``."""

    def __init__(self, in_channels: int, features: int, norm: str = "instance",
                 use_norm: bool = True, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.deconv = make_deconv_2x(in_channels, features)
        self.norm = make_norm(norm, features, dtype) if use_norm else None
        self.dropout_rate = dropout_rate
        self.dtype = dtype

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = conv_transpose2d(self.deconv, x, self.dtype)
        if self.norm is not None:
            x = self.norm(x)
        if self.dropout_rate > 0 and generator is not None:
            x = dropout(x, self.dropout_rate, generator)
        return F.relu(x)

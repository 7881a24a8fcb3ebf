"""Port ops vs the JAX reference on the CPU: pixel conversion, the plain
grid sample, grid pre-reflection, warp-field helpers, the antialiased
preprocess downscale and ``warp_image``.  Inputs come from numpy seeds
and go through both packages."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from pwstablenet_tpu.kernels.grid_sample_pallas import _reflect_grid as jax_reflect_grid
from pwstablenet_tpu.ops import grid_sample as jax_grid_sample
from pwstablenet_tpu.ops import pixels as jax_pixels
from pwstablenet_tpu.ops import warp as jax_warp

from pwstablenet_tpu_torch.kernels.grid_sample import _reflect_grid
from pwstablenet_tpu_torch.ops import pixels, warp
from pwstablenet_tpu_torch.ops.grid_sample import grid_sample


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_to_unit_matches_reference():
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(
        pixels.to_unit(_t(x)).numpy(), np.asarray(jax_pixels.to_unit(jnp.asarray(x)))
    )
    f = np.linspace(-1, 1, 7, dtype=np.float32)
    np.testing.assert_array_equal(pixels.to_unit(_t(f)).numpy(), f)


def test_from_unit_rounds_half_to_even():
    # inputs whose f32 value (x + 1) * 127.5 is exactly k + 0.5
    ties, expect = [], []
    for k in range(-2, 257):
        v = np.float32((k + 0.5) / 127.5 - 1.0)
        if np.float32((v + np.float32(1.0)) * np.float32(127.5)) == k + 0.5:
            ties.append(v)
            expect.append(min(max(k + (k % 2), 0), 255))
    assert len(ties) > 50
    ties = np.asarray(ties, np.float32)
    out = pixels.from_unit(_t(ties)).numpy()
    np.testing.assert_array_equal(out, np.asarray(expect, np.uint8))
    np.testing.assert_array_equal(
        out, np.asarray(jax_pixels.from_unit(jnp.asarray(ties)))
    )


def test_from_unit_matches_reference_and_saturates():
    x = np.random.default_rng(0).uniform(-1.3, 1.3, 4096).astype(np.float32)
    out = pixels.from_unit(_t(x)).numpy()
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, np.asarray(jax_pixels.from_unit(jnp.asarray(x))))


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_plain_grid_sample_matches_reference(mode, padding_mode, align_corners):
    # unit-range pixels, as the reference's own kernel tests use at 1e-6
    rng = np.random.default_rng(1)
    img = rng.random((2, 9, 11, 3), np.float32)
    grid = rng.uniform(-1.4, 1.4, (2, 7, 13, 2)).astype(np.float32)
    ref = jax_grid_sample(
        jnp.asarray(img), jnp.asarray(grid), mode=mode,
        padding_mode=padding_mode, align_corners=align_corners,
    )
    out = grid_sample(_t(img), _t(grid), mode, padding_mode, align_corners)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_plain_grid_sample_is_torch_grid_sample():
    """The written-out sampler has F.grid_sample's semantics."""
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 10, 12, 4)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 6, 8, 2)).astype(np.float32)
    for padding_mode in ("zeros", "border", "reflection"):
        for ac in (True, False):
            ref = F.grid_sample(
                _t(img).permute(0, 3, 1, 2), _t(grid), "bilinear",
                padding_mode, ac,
            ).permute(0, 2, 3, 1)
            out = grid_sample(_t(img), _t(grid), "bilinear", padding_mode, ac)
            np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_plain_grid_sample_rejects_integers():
    with pytest.raises(ValueError, match="float oracle"):
        grid_sample(torch.zeros(1, 2, 2, 3, dtype=torch.uint8), torch.zeros(1, 2, 2, 2))


@pytest.mark.parametrize("align_corners", [True, False])
def test_reflect_grid_matches_reference(align_corners):
    rng = np.random.default_rng(3)
    grid = rng.uniform(-3.5, 3.5, (2, 6, 9, 2)).astype(np.float32)
    for h, w in ((7, 11), (1, 5)):
        ref_g, ref_s = jax_reflect_grid(jnp.asarray(grid), h, w, align_corners)
        g, s = _reflect_grid(_t(grid), h, w, align_corners)
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=1e-6)
        np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


def test_identity_grid_and_flow_to_grid():
    np.testing.assert_allclose(
        warp.identity_grid(5, 9).numpy(),
        np.asarray(jax_warp.identity_grid(5, 9)), atol=1e-7,
    )
    flow = np.random.default_rng(4).standard_normal((2, 6, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        warp.flow_to_grid(_t(flow)).numpy(),
        np.asarray(jax_warp.flow_to_grid(jnp.asarray(flow))), atol=1e-6,
    )


@pytest.mark.parametrize("size", [(20, 28), (45, 80), (5, 6)])
def test_resize_flow_matches_reference(size):
    # displacements of realistic size: O(0.1) normalized units
    rng = np.random.default_rng(5)
    flow = (rng.standard_normal((2, 8, 8, 2)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        warp.resize_flow(_t(flow), *size).numpy(),
        np.asarray(jax_warp.resize_flow(jnp.asarray(flow), *size)), atol=1e-6,
    )


@pytest.mark.parametrize("src", [(48, 64), (45, 70), (20, 24)])
def test_antialiased_downscale_matches_jax_resize(src):
    """The pipeline's preprocess: jax.image.resize bilinear (antialias
    on by default) == F.interpolate(antialias=True, align_corners=False)."""
    x = np.random.default_rng(6).uniform(-1, 1, (3, *src, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (3, 32, 32, 3), method="bilinear")
    out = F.interpolate(
        _t(x).permute(0, 3, 1, 2), size=(32, 32), mode="bilinear",
        align_corners=False, antialias=True,
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _warp_case(seed, dtype):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        img = rng.integers(0, 256, (2, 24, 40, 3), dtype=np.uint8)
    else:
        img = rng.uniform(-1, 1, (2, 24, 40, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 8, 8, 2)) * 0.15).astype(np.float32)
    return img, flow


@pytest.mark.parametrize("padding_mode", ["border", "zeros", "reflection"])
def test_warp_image_float_matches_reference(padding_mode):
    img, flow = _warp_case(7, np.float32)
    ref = jax_warp.warp_image(jnp.asarray(img), jnp.asarray(flow), padding_mode=padding_mode)
    out = warp.warp_image(_t(img), _t(flow), padding_mode=padding_mode)
    assert out.dtype == torch.float32
    # reflection: pre-reflected grid vs direct reflection, f32 rounding
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)


@pytest.mark.parametrize("padding_mode", ["border", "zeros", "reflection"])
def test_warp_image_uint8_matches_reference(padding_mode):
    """JAX's CPU uint8 path is f32 then from_unit; the port's border and
    reflection path is the packed uint8 blend: +-1 code."""
    img, flow = _warp_case(8, np.uint8)
    ref = np.asarray(jax_warp.warp_image(
        jnp.asarray(img), jnp.asarray(flow), padding_mode=padding_mode
    ))
    out = warp.warp_image(_t(img), _t(flow), padding_mode=padding_mode).numpy()
    assert out.dtype == np.uint8 and out.shape == img.shape
    assert np.abs(out.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_warp_image_fused_forward_and_backward():
    img, flow = _warp_case(9, np.float32)
    ref = jax_warp.warp_image_fused(jnp.asarray(img), jnp.asarray(flow))
    f = _t(flow).requires_grad_(True)
    out = warp.warp_image_fused(_t(img), f)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    # the backward is the d/dgrid kernel's plain version on the CPU; the
    # flow is upsampled inside the warp, so each element sums ~15 pixels'
    # gradients (of up to ~40) in each framework's own order
    ref_grad = jax.grad(
        lambda fl: jnp.sum(jax_warp.warp_image_fused(jnp.asarray(img), fl))
    )(jnp.asarray(flow))
    out.sum().backward()
    assert np.abs(np.asarray(ref_grad)).max() > 1.0
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-3)

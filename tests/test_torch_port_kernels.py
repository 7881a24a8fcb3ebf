"""The CUDA kernels' plain versions vs the Pallas TPU kernels (interpret
mode, as tests/test_pallas_kernel.py runs them) and vs the oracle, and
the wrappers' CPU dispatch.  The kernels themselves run only on the card
(``chip_smoke.py`` holds each one against its plain version there)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pwstablenet_tpu.kernels.grid_sample_pallas import grid_sample_pallas_padded
from pwstablenet_tpu.ops import grid_sample as jax_grid_sample
from pwstablenet_tpu.ops.pixels import from_unit as jax_from_unit
from pwstablenet_tpu.ops.pixels import to_unit as jax_to_unit
from pwstablenet_tpu.ops.warp import flow_to_grid as jax_flow_to_grid

from pwstablenet_tpu_torch.kernels import grid_sample as K


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _smooth_grid(b, h, w, mag, seed, cells=4):
    """A stabilization-like grid: a coarse random flow, upsampled."""
    rng = np.random.default_rng(seed)
    lf = (rng.random((b, cells, cells, 2), np.float32) - 0.5) * mag
    flow = jax.image.resize(jnp.asarray(lf), (b, h, w, 2), "bilinear")
    return np.array(jax_flow_to_grid(flow))


@pytest.mark.parametrize(
    "padding_mode,align_corners",
    [("border", True), ("zeros", True), ("reflection", True),
     ("border", False), ("zeros", False), ("reflection", False)],
)
def test_f32_plain_matches_pallas_kernel(padding_mode, align_corners):
    """Padded geometry (W=100 is not a lane multiple): atol 5e-5, the
    reference's own tolerance for its padded wrapper."""
    rng = np.random.default_rng(0)
    img = rng.random((1, 16, 100, 3), np.float32)
    grid = rng.uniform(-1.2, 1.2, (1, 16, 100, 2)).astype(np.float32)
    ref = grid_sample_pallas_padded(
        jnp.asarray(img), jnp.asarray(grid), padding_mode=padding_mode,
        align_corners=align_corners, interpret=True,
    )
    out = K.grid_sample_f32_plain(_t(img), _t(grid), padding_mode, align_corners)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)


@pytest.mark.parametrize("padding_mode", ["border", "reflection"])
def test_packed_plain_matches_pallas_kernel(padding_mode):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (2, 12, 40, 3), dtype=np.uint8)
    grid = rng.uniform(-1.2, 1.2, (2, 12, 40, 2)).astype(np.float32)
    ref = np.asarray(grid_sample_pallas_padded(
        jnp.asarray(img), jnp.asarray(grid), padding_mode=padding_mode,
        interpret=True,
    ))
    out = K.grid_sample_packed_u8_plain(_t(img), _t(grid), padding_mode).numpy()
    assert out.dtype == np.uint8
    assert np.abs(out.astype(np.int32) - ref.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_f32_plain_exact_beyond_pallas_row_window(padding_mode):
    """Vertical displacement of ~+-200 rows at H=480, far past the Pallas
    kernel's +-BR (120) row window: the port is exact to the oracle."""
    b, h, w = 1, 480, 24
    rng = np.random.default_rng(2)
    img = rng.random((b, h, w, 3), np.float32)
    grid = _smooth_grid(b, h, w, mag=0.2, seed=3)
    grid[..., 1] += np.where(np.arange(w) % 2, 0.85, -0.85)[None, None, :]
    ref = jax_grid_sample(jnp.asarray(img), jnp.asarray(grid), padding_mode=padding_mode)
    out = K.grid_sample_f32_plain(_t(img), _t(grid), padding_mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_packed_plain_beyond_pallas_row_window():
    b, h, w = 1, 480, 24
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    grid = _smooth_grid(b, h, w, mag=0.2, seed=5)
    grid[..., 1] += 0.9
    ref = np.asarray(jax_from_unit(jax_grid_sample(
        jax_to_unit(jnp.asarray(img)), jnp.asarray(grid), padding_mode="border"
    )))
    out = K.grid_sample_packed_u8_plain(_t(img), _t(grid)).numpy()
    assert np.abs(out.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_packed_plain_rounds_half_to_even():
    """Blend values that land on .5 round to the even code."""
    img = np.zeros((1, 1, 2, 3), np.uint8)
    img[0, 0, 1] = (1, 2, 3)
    # x = 0.5 exactly between the two pixels (align_corners=True, W=2)
    grid = np.zeros((1, 1, 1, 2), np.float32)
    out = K.grid_sample_packed_u8_plain(_t(img), _t(grid)).numpy()
    np.testing.assert_array_equal(out[0, 0, 0], [0, 1, 2])


def test_wrappers_use_plain_versions_on_cpu():
    K.reset_launch_counts()
    rng = np.random.default_rng(6)
    img = _t(rng.random((2, 10, 14, 3), np.float32))
    u8 = _t(rng.integers(0, 256, (2, 10, 14, 3), dtype=np.uint8))
    grid = _t(rng.uniform(-1.1, 1.1, (2, 10, 14, 2)).astype(np.float32))
    for mode in ("border", "zeros", "reflection"):
        assert torch.equal(
            K.grid_sample_f32(img, grid, mode),
            K.grid_sample_f32_plain(img, grid, mode),
        )
    for mode in ("border", "reflection"):
        assert torch.equal(
            K.grid_sample_packed_u8(u8, grid, mode),
            K.grid_sample_packed_u8_plain(u8, grid, mode),
        )
    assert K.LAUNCHES == {
        "grid_sample_f32": 0, "grid_sample_packed_u8": 0, "grid_sample_grad_f32": 0,
    }


def test_wrappers_validate_inputs():
    img = torch.zeros(1, 4, 4, 3)
    grid = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="float32"):
        K.grid_sample_f32(img.double(), grid)
    with pytest.raises(ValueError, match="uint8"):
        K.grid_sample_packed_u8(img, grid)
    with pytest.raises(ValueError, match="channels"):
        K.grid_sample_packed_u8(torch.zeros(1, 4, 4, 4, dtype=torch.uint8), grid)
    with pytest.raises(ValueError, match="padding_mode"):
        K.grid_sample_packed_u8(torch.zeros(1, 4, 4, 3, dtype=torch.uint8), grid, "zeros")
    with pytest.raises(ValueError, match="batch"):
        K.grid_sample_f32(img, torch.zeros(2, 4, 4, 2))
    # not the CPU and not CUDA: no plain-version path, no kernel
    with pytest.raises(ValueError, match="CUDA"):
        K.grid_sample_f32(img.to("meta"), grid.to("meta"))


def _c_signatures():
    """{name: [ctypes type per parameter]} of each ``extern "C" int
    pwst_*(...)`` in ``csrc/grid_sample.cu``: a pointer parameter is
    ``c_void_p``, an ``int`` parameter ``c_int``."""
    import os
    import re
    import ctypes

    from pwstablenet_tpu_torch.kernels import _build

    with open(os.path.join(_build.CSRC_DIR, "grid_sample.cu")) as f:
        src = f.read()
    sigs = {}
    for name, params in re.findall(r'extern "C" int (pwst_\w+)\(([^)]*)\)', src):
        types = []
        for p in params.split(","):
            p = " ".join(p.split())
            if "*" in p:
                types.append(ctypes.c_void_p)
            else:
                assert re.fullmatch(r"int \w+", p), p
                types.append(ctypes.c_int)
        sigs[name] = types
    return sigs


def test_c_interface_matches_ctypes_signatures():
    """Each C entry point's count and order of pointer/int parameters is
    what the ctypes binding declares (a mismatch would pass a pointer as
    a 32-bit int, or shift every argument, without any error)."""
    from pwstablenet_tpu_torch.kernels import _build

    sigs = _c_signatures()
    assert set(sigs) == set(_build._SIGNATURES)
    for name, types in sigs.items():
        assert types == _build._SIGNATURES[name], name


def test_library_path_follows_the_sources(tmp_path):
    """Another tree's sources (``kernel_ab.py``'s A/B) build into a
    library of their own; the same sources, wherever they lie, into the
    same one."""
    import shutil

    from pwstablenet_tpu_torch.kernels import _build

    other = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, other)
    here = _build._library_path(_build.CSRC_DIR)
    assert _build._library_path(str(other)) == here
    with open(other / "grid_sample.cu", "a") as f:
        f.write("\n// another tree\n")
    assert _build._library_path(str(other)) != here
    assert _build._library_path(_build.CSRC_DIR) == here


def test_kernel_ab_needs_a_card(monkeypatch, capsys):
    """``kernel_ab.py`` exits non-zero without a CUDA card, before it
    builds or times anything."""
    import sys

    import kernel_ab

    monkeypatch.setattr(sys, "argv", ["kernel_ab.py", "."])
    assert kernel_ab.main() == 1
    assert "no CUDA device" in capsys.readouterr().err


def _offset_view(a, k):
    """``a`` copied into a tensor view ``k`` elements into its storage."""
    t = torch.from_numpy(np.ascontiguousarray(a)).reshape(-1)
    buf = torch.empty(t.numel() + k, dtype=t.dtype)
    buf[k:] = t
    return buf[k:].view(a.shape)


# (image shape, grid shape, storage offset of the image view in elements)
_SHAPE_CASES = {
    "W=37": ((2, 5, 37), (2, 5, 37), 0),
    "W=853": ((1, 4, 853), (1, 4, 853), 0),
    "HoWo!=HW": ((2, 12, 24), (2, 5, 11), 0),
    "image_view_offset": ((2, 6, 13), (2, 6, 13), 3),
}


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["border", "zeros", "reflection"])
@pytest.mark.parametrize("case", list(_SHAPE_CASES))
def test_f32_plain_matches_jax_oracle_shapes(case, padding_mode, align_corners):
    """The f32 plain version at the shapes the grouped kernel finds
    hardest: a ragged row tail, an odd wide row, an output size unlike
    the image's, and an image view off its storage's start.

    atol 1e-6 where both compute the source coordinate alike.  With
    ``align_corners=False`` XLA's CPU backend contracts ``(g+1)*size-1``
    into a fused multiply-add, and reflection is a pre-reflected grid in
    the port against a reflected coordinate in the oracle: there the
    coordinates differ by rounding, and the values (pixel steps <= 1) by
    at most one float32 spacing of the largest coordinate."""
    (b, h, w), (_, ho, wo), k = _SHAPE_CASES[case]
    rng = np.random.default_rng(10)
    img = rng.random((b, h, w, 3), np.float32)
    grid = rng.uniform(-1.2, 1.2, (b, ho, wo, 2)).astype(np.float32)
    ref = jax_grid_sample(jnp.asarray(img), jnp.asarray(grid),
                          padding_mode=padding_mode, align_corners=align_corners)
    out = K.grid_sample_f32_plain(_offset_view(img, k), _t(grid), padding_mode, align_corners)
    assert out.shape == (b, ho, wo, 3)
    exact = align_corners and padding_mode != "reflection"
    atol = 1e-6 if exact else max(1e-6, float(np.spacing(np.float32(max(h, w)))))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["border", "reflection"])
@pytest.mark.parametrize("case", list(_SHAPE_CASES))
def test_packed_plain_matches_jax_oracle_shapes(case, padding_mode, align_corners):
    """The packed plain version against the f32 oracle through
    ``to_unit`` / ``from_unit`` at the same shapes (+-1 code)."""
    (b, h, w), (_, ho, wo), k = _SHAPE_CASES[case]
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    grid = rng.uniform(-1.2, 1.2, (b, ho, wo, 2)).astype(np.float32)
    ref = np.asarray(jax_from_unit(jax_grid_sample(
        jax_to_unit(jnp.asarray(img)), jnp.asarray(grid),
        padding_mode=padding_mode, align_corners=align_corners,
    )))
    out = K.grid_sample_packed_u8_plain(
        _offset_view(img, k), _t(grid), padding_mode, align_corners).numpy()
    assert out.shape == (b, ho, wo, 3) and out.dtype == np.uint8
    assert np.abs(out.astype(np.int32) - ref.astype(np.int32)).max() <= 1

"""The d/dgrid kernel's plain version vs the Pallas TPU kernel
(``grid_sample_grad_pallas_padded`` in interpret mode, as
tests/test_pallas_kernel.py runs it), the tie semantics at the clamp
boundary, and the fused warp's flow gradient vs the JAX package's.  The
kernel itself runs only on the card (``chip_smoke.py`` holds it against
its plain version there).

Tolerance: atol 2e-4 / rtol 1e-4, the reference's own for its gradient
kernel (tests/test_pallas_kernel.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pwstablenet_tpu.kernels.grid_sample_pallas import grid_sample_grad_pallas_padded
from pwstablenet_tpu.ops import grid_sample as jax_grid_sample
from pwstablenet_tpu.ops import warp as jax_warp

from pwstablenet_tpu_torch.kernels import grid_sample as K
from pwstablenet_tpu_torch.ops import warp

from test_torch_port_kernels import _SHAPE_CASES, _offset_view

ATOL, RTOL = 2e-4, 1e-4
MODES = [(m, ac) for m in ("border", "zeros", "reflection") for ac in (True, False)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _smooth_grid(b, h, w, mag, seed, cells=4):
    rng = np.random.default_rng(seed)
    lf = (rng.random((b, cells, cells, 2), np.float32) - 0.5) * mag
    flow = jax.image.resize(jnp.asarray(lf), (b, h, w, 2), "bilinear")
    return np.array(jax_warp.flow_to_grid(flow))


def _identity(b, h, w):
    g = np.asarray(jax_warp.identity_grid(h, w))
    return np.ascontiguousarray(np.broadcast_to(g, (b, h, w, 2)))


CASES = ["smooth", "smooth_padded", "rows40", "identity"]


def _case(name):
    """(image, grid, cotangent) as numpy float32."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "smooth":        # unpadded TPU geometry
        b, h, w = 2, 16, 128
        grid = _smooth_grid(b, h, w, 0.3, seed=1)
    elif name == "smooth_padded":   # W=100: the padded wrapper's remap
        b, h, w = 1, 12, 100
        grid = _smooth_grid(b, h, w, 0.3, seed=2)
    elif name == "rows40":      # +-40-row vertical displacement at H=128
        b, h, w = 1, 128, 128
        grid = _smooth_grid(b, h, w, 0.1, seed=3)
        grid[..., 1] += np.where(np.arange(w) % 2, 1.0, -1.0) * 40.0 / (0.5 * (h - 1))
    elif name == "identity":    # every edge pixel exactly on the clamp boundary
        b, h, w = 2, 16, 128
        grid = _identity(b, h, w)
    else:
        raise ValueError(name)
    img = rng.random((b, h, w, 3), np.float32)
    cot = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    return img, grid.astype(np.float32), cot


def _pallas(img, grid, cot, mode, ac):
    return np.asarray(grid_sample_grad_pallas_padded(
        jnp.asarray(img), jnp.asarray(grid), jnp.asarray(cot),
        padding_mode=mode, align_corners=ac, interpret=True,
    ))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_grad_plain_matches_pallas_kernel(case, padding_mode, align_corners):
    img, grid, cot = _case(case)
    ref = _pallas(img, grid, cot, padding_mode, align_corners)
    out = K.grid_sample_grad_f32_plain(
        _t(img), _t(grid), _t(cot), padding_mode, align_corners
    ).numpy()
    assert out.shape == grid.shape and np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_tie_on_the_clamp_boundary_follows_the_tpu_kernel():
    """Identity grid, border, align_corners: the top/left edge pixels sit
    at x = 0 / y = 0 exactly.  The port keeps the gradient there, as the
    Pallas kernel does (closed range [0, size-1]); ``jax.grad`` of the
    XLA sampler (the JAX package's CPU path) gives half of it, because
    ``jnp.clip`` splits the tie.  The bottom row (y = H-1 exactly) reads
    the tap row below the frame as 0, as the TPU kernel's row window
    does."""
    img, grid, cot = _case("identity")
    out = K.grid_sample_grad_f32_plain(_t(img), _t(grid), _t(cot)).numpy()
    tpu = _pallas(img, grid, cot, "border", True)

    def scalar(g):
        return jnp.sum(jnp.asarray(cot) * jax_grid_sample(
            jnp.asarray(img), g, padding_mode="border", align_corners=True))

    xla = np.asarray(jax.grad(scalar)(jnp.asarray(grid)))
    left, top, bottom = out[:, :, 0, 0], out[:, 0, :, 1], out[:, -1, :, 1]
    np.testing.assert_allclose(left, tpu[:, :, 0, 0], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(top, tpu[:, 0, :, 1], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(bottom, tpu[:, -1, :, 1], atol=ATOL, rtol=RTOL)
    # XLA halves the tie: the reference's own CPU/TPU split
    np.testing.assert_allclose(xla[:, :, 0, 0], 0.5 * left, atol=ATOL, rtol=1e-3)
    np.testing.assert_allclose(xla[:, 0, :, 1], 0.5 * top, atol=ATOL, rtol=1e-3)
    assert np.abs(xla[:, :, 0, 0] - left).max() > 1.0
    # away from the edges all three agree
    inner = (slice(None), slice(1, -1), slice(1, -1))
    np.testing.assert_allclose(out[inner], xla[inner], atol=ATOL, rtol=RTOL)


# the f32 kernel's hard shapes, plus the generic channel path
_GRAD_SHAPE_CASES = {
    **{k: (*v, 3) for k, v in _SHAPE_CASES.items()},
    "C=1": ((2, 9, 14), (2, 9, 14), 0, 1),
    "C=5": ((2, 9, 14), (2, 9, 14), 0, 5),
}


@pytest.mark.parametrize("padding_mode,align_corners", MODES)
@pytest.mark.parametrize("case", list(_GRAD_SHAPE_CASES))
def test_grad_plain_matches_jax_grad_shapes(case, padding_mode, align_corners):
    """The d/dgrid plain version against ``jax.grad`` of ``sum(cot *
    grid_sample(image, grid))`` through the JAX package's XLA sampler, at
    the shapes the redesigned kernel finds hardest: a ragged row, an odd
    wide row (tap pairs at both 8-byte alignments), an output size
    unlike the image's, image, grid and cotangent views off their
    storage's start, and 1 and 5 channels.

    The grid is uniform in (-1.2, 1.2), so no coordinate sits on a clamp
    tie, where the XLA sampler halves the gradient (``ROADMAP.md``
    Queue 3).  atol 2e-4 / rtol 1e-4 in every mode, unwidened: where the
    source coordinates differ by rounding (``align_corners=False``, whose
    ``(g+1)*size-1`` XLA contracts into a fused multiply-add, and the
    pre-reflected grid against a reflected coordinate), the gradient
    along one axis moves by an ulp of the other axis's fraction times
    its scale; the largest excess over rtol at these shapes is 5.9e-5
    (W = 853, reflection, ``align_corners=False``)."""
    (b, h, w), (_, ho, wo), k, c = _GRAD_SHAPE_CASES[case]
    rng = np.random.default_rng(12)
    img = rng.random((b, h, w, c), np.float32)
    grid = rng.uniform(-1.2, 1.2, (b, ho, wo, 2)).astype(np.float32)
    cot = rng.standard_normal((b, ho, wo, c)).astype(np.float32)

    def scalar(g):
        return jnp.sum(jnp.asarray(cot) * jax_grid_sample(
            jnp.asarray(img), g, padding_mode=padding_mode, align_corners=align_corners))

    ref = np.asarray(jax.grad(scalar)(jnp.asarray(grid)))
    out = K.grid_sample_grad_f32_plain(
        _offset_view(img, k), _offset_view(grid, k), _offset_view(cot, k),
        padding_mode, align_corners,
    ).numpy()
    assert out.shape == (b, ho, wo, 2) and np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_fused_warp_flow_gradient_matches_jax():
    """``warp_image_fused``'s flow gradient on a smooth non-identity flow
    against ``jax.grad`` of the JAX ``warp_image_fused``: atol 1e-4, as
    tests/test_pallas_kernel.py holds the reference's fused warp.  The
    flow is given at the image size, so each gradient element is one
    pixel's (a resize's backward would sum ~100 of them in each
    framework's own order).  The frame is narrow (16x24): each element
    carries the x-scale 0.5*(W-1) twice over (an ulp of the identity
    grid moves fx by the scale, and the gradient scales again), so the
    absolute tolerance needs a small one."""
    rng = np.random.default_rng(4)
    img = rng.random((1, 16, 24, 3), np.float32)
    flow = _smooth_grid(1, 16, 24, 0.1, seed=6) - _identity(1, 16, 24)
    tgt = rng.random((1, 16, 24, 3), np.float32)

    def loss_jax(f):
        return jnp.sum((jax_warp.warp_image_fused(jnp.asarray(img), f) - tgt) ** 2)

    ref = np.asarray(jax.grad(loss_jax)(jnp.asarray(flow)))
    f = _t(flow).requires_grad_(True)
    im = _t(img).requires_grad_(True)
    loss = torch.sum((warp.warp_image_fused(im, f) - _t(tgt)) ** 2)
    loss.backward()
    assert im.grad is None  # the image is data: no gradient by contract
    np.testing.assert_allclose(f.grad.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("padding_mode", ["border", "zeros", "reflection"])
def test_fused_backward_uses_the_plain_version_on_cpu(padding_mode):
    K.reset_launch_counts()
    rng = np.random.default_rng(5)
    img = _t(rng.random((2, 10, 14, 3), np.float32))
    grid = _t(rng.uniform(-1.1, 1.1, (2, 10, 14, 2)).astype(np.float32))
    cot = _t(rng.standard_normal((2, 10, 14, 3)).astype(np.float32))
    g = grid.clone().requires_grad_(True)
    out = warp._FusedSample.apply(img, g, padding_mode, True)
    out.backward(cot)
    assert torch.equal(g.grad, K.grid_sample_grad_f32_plain(img, grid, cot, padding_mode))
    assert torch.equal(
        K.grid_sample_grad_f32(img, grid, cot, padding_mode),
        K.grid_sample_grad_f32_plain(img, grid, cot, padding_mode),
    )
    assert all(v == 0 for v in K.LAUNCHES.values())


def test_grad_wrapper_validates_inputs():
    img = torch.zeros(1, 4, 4, 3)
    grid = torch.zeros(1, 4, 4, 2)
    cot = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="cotangent must have shape"):
        K.grid_sample_grad_f32(img, grid, torch.zeros(1, 4, 4, 2))
    with pytest.raises(ValueError, match="cotangent must be float32"):
        K.grid_sample_grad_f32(img, grid, cot.double())
    with pytest.raises(ValueError, match="padding_mode"):
        K.grid_sample_grad_f32(img, grid, cot, "wrap")
    # not the CPU and not CUDA: no plain-version path, no kernel
    with pytest.raises(ValueError, match="CUDA"):
        K.grid_sample_grad_f32(img.to("meta"), grid.to("meta"), cot.to("meta"))


class _RefusingLibrary:
    """A kernel library whose every C entry point refuses its launch with
    CUDA error 1, as the C interface does beyond the launch's limits."""

    def __getattr__(self, name):
        assert name.startswith("pwst_"), name
        return lambda *args: 1


@pytest.mark.parametrize("kernel", list(K.LAUNCHES))
def test_refused_launch_names_the_limits(kernel, monkeypatch):
    """Each wrapper turns a refused launch into an error that names its
    kernel and the limits shared by all three kernels' C interface, and
    does not count it.  CPU-side: the forward operators' CUDA
    implementations, and the d/dgrid wrapper taken past its CPU dispatch,
    run on CPU tensors against a library that refuses, so nothing
    launches."""
    from types import SimpleNamespace

    monkeypatch.setattr(K, "_on_cpu", lambda image, grid: False)
    monkeypatch.setattr(K, "library", lambda: _RefusingLibrary())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    K.reset_launch_counts()
    img = torch.zeros(1, 4, 4, 3)
    grid = torch.zeros(1, 4, 4, 2)
    call = {
        "grid_sample_f32": lambda: K._f32_cuda(img, grid, False, True),
        "grid_sample_packed_u8": lambda: K._packed_u8_cuda(img.to(torch.uint8), grid, True),
        "grid_sample_grad_f32": lambda: K.grid_sample_grad_f32(img, grid, torch.zeros(1, 4, 4, 3)),
    }[kernel]
    with pytest.raises(RuntimeError) as info:
        call()
    msg = str(info.value)
    assert msg.startswith(f"{kernel} launch failed: CUDA error 1")
    for limit in ("H*W*C < 2^31", "B <= 65535", "Ho <= 524280"):
        assert limit in msg
    assert all(v == 0 for v in K.LAUNCHES.values())

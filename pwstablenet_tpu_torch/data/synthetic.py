"""Procedural DeepStab-like synthetic clips: a numpy copy of the JAX
package's ``data/synthetic.py`` (the port imports nothing of that
package).  For a given seed ``make_train_batch`` returns the same bytes
as the reference's; ``tests/test_torch_port_train.py`` holds the two
equal.

A world observed by a "stable" camera and by a jittering "unstable"
camera, with optional perspective shake, parallax layers, moving
occluders, photometric jitter, textureless regions, motion blur and
exposure steps.  All knobs default OFF; the ``RICH`` preset enables all
of them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# Preset enabling the full scene model (pass **RICH to synthetic_pair_clip,
# or rich=True to make_train_batch / write_synthetic_deepstab).
RICH: Dict[str, float] = dict(
    perspective=2.0,       # ~2 px of perspective-only shake at frame edges
    parallax_layers=2,     # base plane + 2 closer layers
    num_occluders=1,
    photometric=0.5,       # +-5% static gain, +-5% flicker, sigma~0.01 noise
    textureless_frac=0.15, # ~15% of the base plane near-constant
    motion_blur=0.6,       # ~60% shutter fraction of the frame motion
    exposure_steps=0.5,    # occasional +-12% persistent exposure jumps
)


def _texture(
    rng: np.random.Generator, h: int, w: int, c: int = 3,
    detail_px: float = 0.0,
) -> np.ndarray:
    """Smooth random texture in [-1, 1] with multi-scale detail.

    The base octaves place 4..32 control points across the image, so the
    finest detail is ``min(h, w) / 32`` pixels — resolution-RELATIVE.
    At 320x448 that is ~10 px (plenty of trackable corners); at 720p+ it
    is 25-60 px, i.e. a near-featureless world where neither the model
    nor a feature-tracking metric has anything to lock onto (a real
    720p video has fine texture).  ``detail_px > 0`` appends octaves
    until the control-point spacing reaches ~``detail_px`` pixels at
    native resolution, making scene detail resolution-ABSOLUTE.  The
    extra rng draws happen only when the knob is on, so knob-off
    streams (and every previously trained/evaluated clip) stay
    bit-identical.
    """
    img = np.zeros((h, w, c), np.float32)
    scales = [4, 8, 16, 32]
    if detail_px > 0:
        s = scales[-1] * 2
        while min(h, w) / (s / 2) > detail_px and s <= min(h, w):
            scales.append(s)
            s *= 2
    for scale in scales:
        small = rng.standard_normal((scale, scale, c)).astype(np.float32)
        # bilinear upsample via np (small sizes; host-side only)
        ys = np.linspace(0, scale - 1, h)
        xs = np.linspace(0, scale - 1, w)
        y0 = np.floor(ys).astype(int).clip(0, scale - 2)
        x0 = np.floor(xs).astype(int).clip(0, scale - 2)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        up = (
            small[y0][:, x0] * (1 - fy) * (1 - fx)
            + small[y0][:, x0 + 1] * (1 - fy) * fx
            + small[y0 + 1][:, x0] * fy * (1 - fx)
            + small[y0 + 1][:, x0 + 1] * fy * fx
        )
        img += up / scale**0.5
    m = np.abs(img).max() or 1.0
    return (img / m).astype(np.float32)


def _smooth_field(rng: np.random.Generator, h: int, w: int, scale: int = 6) -> np.ndarray:
    """Smooth scalar field in roughly [-1, 1], for masks/blobs."""
    return _texture(rng, h, w, c=1)[..., 0]


def _sample_bilinear(img: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    chan = img.ndim == 3
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    fy = ys - y0
    fx = xs - x0
    if chan:
        fy = fy[..., None]
        fx = fx[..., None]
    y0c = y0.clip(0, h - 1); y1c = (y0 + 1).clip(0, h - 1)
    x0c = x0.clip(0, w - 1); x1c = (x0 + 1).clip(0, w - 1)
    return (
        img[y0c, x0c] * (1 - fy) * (1 - fx)
        + img[y0c, x1c] * (1 - fy) * fx
        + img[y1c, x0c] * fy * (1 - fx)
        + img[y1c, x1c] * fy * fx
    ).astype(np.float32)


class _Occluder:
    """Independently moving textured ellipse at near depth."""

    def __init__(self, rng: np.random.Generator, h: int, w: int,
                 num_frames: int,
                 pan_y: np.ndarray = None, pan_x: np.ndarray = None):
        self.ry = float(rng.uniform(0.08, 0.16)) * h
        self.rx = float(rng.uniform(0.08, 0.16)) * w
        th = int(2 * self.ry) + 8
        tw = int(2 * self.rx) + 8
        self.tex = _texture(rng, th, tw)
        self.depth = float(rng.uniform(1.3, 1.8))  # parallax factor
        # smooth independent trajectory: slow sinusoid mix crossing the frame
        t = np.arange(num_frames, dtype=np.float32)
        f1, f2 = rng.uniform(0.5, 1.5, 2) / max(num_frames, 1)
        ph = rng.uniform(0, 2 * np.pi, 4)
        cy0 = rng.uniform(0.2, 0.8) * h
        cx0 = rng.uniform(0.2, 0.8) * w
        amp_y = rng.uniform(0.1, 0.25) * h
        amp_x = rng.uniform(0.1, 0.25) * w
        drift = rng.uniform(-0.6, 0.6, 2)
        def reflect(path: np.ndarray, span: float) -> np.ndarray:
            # bounce the trajectory off the frame edges so the occluder
            # keeps occluding arbitrarily long clips (its own drift
            # would otherwise exit the frame)
            p = np.mod(path, 2.0 * span)
            return np.where(p > span, 2.0 * span - p, p)

        self.path_y = reflect(
            cy0 + amp_y * np.sin(2 * np.pi * f1 * t + ph[0]) + drift[0] * t,
            float(h),
        ).astype(np.float32)
        self.path_x = reflect(
            cx0 + amp_x * np.sin(2 * np.pi * f2 * t + ph[1]) + drift[1] * t,
            float(w),
        ).astype(np.float32)
        # anchor the trajectory to the PANNING camera (pan offset folded
        # into the world path) so cumulative pan doesn't drift occluders
        # off-frame late in long clips; only shake/parallax moves them
        # across the two views
        if pan_y is not None:
            self.path_y = self.path_y + pan_y * self.depth
        if pan_x is not None:
            self.path_x = self.path_x + pan_x * self.depth

    def composite(self, frame: np.ndarray, vy: np.ndarray, vx: np.ndarray,
                  t: int, cam_oy: float, cam_ox: float) -> np.ndarray:
        """Alpha-composite the occluder over ``frame``.

        ``vy/vx``: the view's (possibly homography-warped) base sampling
        coordinates in screen space; the occluder lives at world position
        path(t) on a near layer, so its screen position shifts by
        camera_offset * depth-factor like any near-depth content.
        """
        dy = vy + cam_oy * self.depth - self.path_y[t]
        dx = vx + cam_ox * self.depth - self.path_x[t]
        q = (dy / self.ry) ** 2 + (dx / self.rx) ** 2
        # soft ellipse edge (argument clipped: far pixels overflow exp)
        alpha = 1.0 / (1.0 + np.exp(np.clip((q - 1.0) / 0.08, -60, 60)))
        th, tw = self.tex.shape[:2]
        tex = _sample_bilinear(self.tex, dy + th / 2, dx + tw / 2)
        out = frame * (1 - alpha[..., None]) + tex * alpha[..., None]
        return out.astype(np.float32)


def _flatten_textureless(rng: np.random.Generator, world: np.ndarray,
                         frac: float) -> np.ndarray:
    """Flatten ~frac of the texture to near-constant blobs (regions where
    the warp is unconstrained by image evidence)."""
    h, w = world.shape[:2]
    field = _smooth_field(rng, h, w)
    thresh = np.quantile(field, 1.0 - frac)
    mask = 1.0 / (1.0 + np.exp(-(field - thresh) / 0.02))  # soft edges
    flat_color = world.mean(axis=(0, 1), keepdims=True)
    return (world * (1 - mask[..., None])
            + flat_color * mask[..., None]).astype(np.float32)


def synthetic_pair_clip(
    num_frames: int,
    height: int,
    width: int,
    seed: int = 0,
    shake_px: float = 6.0,
    pan_px: float = 1.0,
    perspective: float = 0.0,
    parallax_layers: int = 0,
    num_occluders: int = 0,
    photometric: float = 0.0,
    textureless_frac: float = 0.0,
    motion_blur: float = 0.0,
    exposure_steps: float = 0.0,
    texture_detail_px: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (stable, unstable) clips, each (T, H, W, 3) in [-1, 1].

    The stable camera pans smoothly over the world; the unstable camera
    follows the same path plus per-frame random translation, rotation
    and (``perspective > 0``) homography shake.  See module docstring
    for the scene-model knobs; all default to the original flat world.

    ``perspective`` is calibrated in pixels of extra displacement at the
    frame edge.  ``photometric`` in [0, 1] scales gain/flicker/noise.
    ``motion_blur`` in [0, 1] is the shutter fraction: the unstable view
    is streaked along that fraction of its inter-frame apparent motion.
    ``exposure_steps`` in [0, 1] scales sudden persistent exposure jumps
    on the unstable view (auto-exposure hunting; ~6% of frames jump).
    ``texture_detail_px`` > 0 adds fine texture octaves down to ~that
    pixel scale at native resolution (see ``_texture``) — REQUIRED for
    meaningful clips above ~480p, where the base octaves alone leave the
    world featureless relative to the frame.
    """
    rng = np.random.default_rng(seed)
    margin = int(shake_px * 4 + pan_px * num_frames + 8)
    wh, ww = height + 2 * margin, width + 2 * margin

    # ---- world: base plane + optional parallax layers ----------------
    base = _texture(rng, wh, ww, detail_px=texture_detail_px)
    if textureless_frac > 0:
        base = _flatten_textureless(rng, base, textureless_frac)
    layers: List[Tuple[np.ndarray, np.ndarray, float]] = []  # (tex, alpha, depth)
    for k in range(parallax_layers):
        tex = _texture(rng, wh, ww, detail_px=texture_detail_px)
        field = _smooth_field(rng, wh, ww)
        # each layer covers ~25% of the view with soft-edged blobs
        thresh = np.quantile(field, 0.75)
        alpha = 1.0 / (1.0 + np.exp(-(field - thresh) / 0.02))
        depth = 1.0 + 0.2 * (k + 1)  # closer => moves more with the camera
        layers.append((tex, alpha.astype(np.float32), depth))

    # camera pan path, precomputed so occluders can anchor to it
    t_arr = np.arange(num_frames, dtype=np.float32)
    pan_x_arr = pan_px * t_arr
    pan_y_arr = 0.3 * pan_px * t_arr

    occluders = [
        _Occluder(rng, height, width, num_frames,
                  pan_y=pan_y_arr, pan_x=pan_x_arr)
        for _ in range(num_occluders)
    ]

    gy, gx = np.meshgrid(
        np.arange(height, dtype=np.float32),
        np.arange(width, dtype=np.float32),
        indexing="ij",
    )
    cy, cx = height / 2, width / 2

    def render(vy: np.ndarray, vx: np.ndarray, oy: float, ox: float,
               t: int) -> np.ndarray:
        """Composite all layers far-to-near for a view whose base-plane
        sampling coords are (vy + oy + margin, vx + ox + margin); closer
        layers see the camera offset scaled by their depth factor."""
        img = _sample_bilinear(base, vy + oy + margin, vx + ox + margin)
        for tex, alpha, depth in layers:
            ly = vy + oy * depth + margin
            lx = vx + ox * depth + margin
            a = _sample_bilinear(alpha, ly, lx)[..., None]
            img = img * (1 - a) + _sample_bilinear(tex, ly, lx) * a
        for occ in occluders:
            img = occ.composite(img, vy, vx, t, oy, ox)
        return img

    # ---- photometric model -------------------------------------------
    # static per-channel gain mismatch between the two cameras, plus a
    # mean-reverting exposure-flicker walk and sensor noise (unstable
    # only).  All draws are GATED on the knob so knob-off clips consume
    # exactly the original generator's rng stream (bit-identical output).
    cam_gain = (
        1.0 + rng.standard_normal(3).astype(np.float32) * 0.05 * photometric
        if photometric > 0 else np.ones(3, np.float32)
    )
    flicker = 0.0
    noise_sigma = 0.02 * photometric

    def photometric_jitter(img: np.ndarray, gain: float) -> np.ndarray:
        # applies whenever the photometric model OR an exposure-step
        # gain is active; the noise draw stays gated on `photometric`
        # so knob-off rng streams are untouched
        if photometric <= 0 and abs(gain - 1.0) < 1e-12:
            return img
        lin = (img + 1.0) * 0.5
        lin = lin * cam_gain[None, None, :] * gain
        if noise_sigma > 0:
            lin = lin + (
                rng.standard_normal(img.shape).astype(np.float32)
                * noise_sigma
            )
        return np.clip(lin * 2.0 - 1.0, -1.0, 1.0).astype(np.float32)

    stable_frames, unstable_frames = [], []
    jitter = np.zeros(2, np.float32)
    persp = np.zeros(2, np.float32)  # homography perspective row (p_y, p_x)
    exp_gain = 1.0  # piecewise-constant exposure level (step events)
    prev_off = np.zeros(2, np.float32)  # last unstable camera offset
    # calibrate: coords at frame edge ~(H/2, W/2); displacement there is
    # roughly |p| * (H/2)^2 for the pure-perspective term, so draw p with
    # std such that edge displacement ~= `perspective` px.
    p_scale = perspective / max((max(height, width) / 2) ** 2, 1.0)
    for t in range(num_frames):
        ox = float(pan_x_arr[t])
        oy = float(pan_y_arr[t])
        stable_frames.append(render(gy, gx, oy, ox, t))

        # random-walk shake, mean-reverting: translation + rotation + persp.
        jitter = 0.7 * jitter + rng.standard_normal(2).astype(np.float32) * shake_px * 0.5
        theta = rng.standard_normal() * 0.004
        ry = np.cos(theta) * (gy - cy) - np.sin(theta) * (gx - cx)
        rx = np.sin(theta) * (gy - cy) + np.cos(theta) * (gx - cx)
        if perspective > 0:
            persp = 0.7 * persp + rng.standard_normal(2).astype(np.float32) * p_scale * 0.5
            denom = 1.0 + persp[0] * ry + persp[1] * rx
            ry = ry / denom
            rx = rx / denom
        ry = ry + cy
        rx = rx + cx
        frame = render(ry, rx, oy + jitter[0], ox + jitter[1], t)

        # motion blur: streak along the instantaneous apparent motion
        # (inter-frame camera-offset delta), shutter open for
        # `motion_blur` of the frame interval.  Post-render directional
        # average — no rng, so knob-off streams are untouched.
        off = np.array([oy + jitter[0], ox + jitter[1]], np.float32)
        if motion_blur > 0 and t > 0:
            vy_px = float(off[0] - prev_off[0])
            vx_px = float(off[1] - prev_off[1])
            if vy_px * vy_px + vx_px * vx_px > 0.25:  # >0.5 px of motion
                taps = 5
                acc = np.zeros_like(frame)
                for a in np.linspace(-0.5, 0.5, taps):
                    acc += _sample_bilinear(
                        frame,
                        gy + a * motion_blur * vy_px,
                        gx + a * motion_blur * vx_px,
                    )
                frame = (acc / taps).astype(np.float32)
        prev_off = off

        if photometric > 0:
            flicker = 0.6 * flicker + rng.standard_normal() * 0.05 * photometric
        if exposure_steps > 0 and rng.uniform() < 0.06:
            # auto-exposure hunting: a persistent jump (held until the
            # next event), distinct from the mean-reverting flicker
            exp_gain = 1.0 + float(rng.uniform(-0.25, 0.25)) * exposure_steps
        unstable_frames.append(
            photometric_jitter(frame, (1.0 + flicker) * exp_gain)
        )
    return np.stack(stable_frames), np.stack(unstable_frames)


def _quantize(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8 transport format (matches real decoded
    video, which is natively 8-bit; see ops.pixels / data.video_io)."""
    return np.clip((x + 1.0) * 127.5, 0, 255).round().astype(np.uint8)


def make_train_batch(
    batch_size: int,
    height: int,
    width: int,
    temporal_window: int,
    seed: int = 0,
    dtype=np.uint8,
    rich: bool = False,
    temporal_center=None,
    **clip_kwargs,
) -> dict:
    """Synthetic batch in the train-step format: two consecutive time
    steps per sample (for the temporal loss).

    Batches are uint8 by default — the device-transport format (the
    train step normalizes on device); pass ``dtype=np.float32`` for
    host-side floats in [-1, 1].  ``rich=True`` enables the full scene
    model (``RICH``); extra kwargs pass through to
    ``synthetic_pair_clip``.  ``temporal_center``: current-frame
    position in the stack (None = centered; T-1 = causal).
    """
    if rich:
        clip_kwargs = {**RICH, **clip_kwargs}
    rng = np.random.default_rng(seed)
    past = (
        temporal_window // 2 if temporal_center is None else temporal_center
    )
    future = temporal_window - 1 - past
    stacks = np.zeros(
        (batch_size, 2, height, width, temporal_window * 3), np.float32
    )
    stable = np.zeros((batch_size, 2, height, width, 3), np.float32)
    for b in range(batch_size):
        t0 = past + 1
        frames = temporal_window + 2
        s, u = synthetic_pair_clip(
            frames, height, width, seed=int(rng.integers(1 << 31)),
            **clip_kwargs,
        )
        for k in range(2):  # two consecutive centers: t0, t0+1
            t = t0 + k
            window = u[t - past : t + future + 1]
            stacks[b, k] = window.transpose(1, 2, 0, 3).reshape(
                height, width, temporal_window * 3
            )
            stable[b, k] = s[t]
    if np.dtype(dtype) == np.uint8:
        return {"stacks": _quantize(stacks), "stable": _quantize(stable)}
    return {"stacks": stacks, "stable": stable}

"""Offline video-stabilization quality metrics: a copy of the JAX
package's ``eval/metrics.py``, number for number (its known oddities
included: ``stability_score`` is 1.0 on a clip with no transforms).

The standard trio used by the stabilization literature (and by the
PWStableNet paper's evaluation): cropping ratio, distortion value, and
stability score, plus jitter, PSNR and SSIM.

Definitions (following the common protocol of Liu et al. / the
PWStableNet paper's evaluation section):

- **cropping ratio**: mean scale of the homography mapping original ->
  stabilized frames (how much content survives; closer to 1 is better).
- **distortion value**: worst-case anisotropy of those homographies'
  affine parts — ratio of the two largest eigenvalues' magnitudes
  (closer to 1 is better).
- **stability score**: energy of the low-frequency (2nd-6th) components
  of the inter-frame motion trajectory as a fraction of total spectral
  energy (higher is smoother camera path).

All host-side (numpy + OpenCV feature tracking) — offline analysis,
not on the device path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _to_gray_u8(frame: np.ndarray) -> np.ndarray:
    import cv2

    u8 = np.clip((frame + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return cv2.cvtColor(u8, cv2.COLOR_RGB2GRAY)


def _track_affine(
    a: np.ndarray, b: np.ndarray, full: bool = False
) -> Optional[np.ndarray]:
    """Estimate a 2x3 affine transform from frame a to frame b.

    ``full=False`` fits a similarity (4-DOF — the right model for the
    camera-path trajectories behind the stability score);
    ``full=True`` fits the full 6-DOF affine — required by the
    distortion metric, whose whole point is the ANISOTROPY of the
    original->stabilized mapping (a similarity fit is isotropic by
    construction and would report distortion == 1 always).
    """
    import cv2

    ga, gb = _to_gray_u8(a), _to_gray_u8(b)
    # corner budget scales with frame area so high resolutions are not
    # starved (a fixed 200 corners is dense at 320x448 but sparse at
    # 1080p, where a handful of features on a moving foreground object
    # can hijack the fit)
    max_corners = max(200, (ga.shape[0] * ga.shape[1]) // 2000)
    # corner spacing scales with the frame so a small high-contrast
    # foreground object cannot supply a large share of the corners (at
    # 720p a textured occluder covering ~3% of the frame was providing
    # ~37% of fixed-spacing corners and dragging the global fit)
    min_dist = max(8, min(ga.shape[0], ga.shape[1]) // 36)
    pts = cv2.goodFeaturesToTrack(
        ga, maxCorners=max_corners, qualityLevel=0.01,
        minDistance=min_dist,
    )
    if pts is None or len(pts) < 8:
        return None
    lk = dict(winSize=(21, 21), maxLevel=4)
    nxt, status, _ = cv2.calcOpticalFlowPyrLK(ga, gb, pts, None, **lk)
    # forward-backward consistency: re-track to the source frame and
    # keep only points that land back where they started (drops the
    # silently-diverged tracks that otherwise poison the RANSAC fit on
    # blurred / low-texture frames)
    back, status2, _ = cv2.calcOpticalFlowPyrLK(gb, ga, nxt, None, **lk)
    fb_err = np.linalg.norm(
        (back - pts).reshape(-1, 2), axis=1
    )
    ok = (status.ravel() == 1) & (status2.ravel() == 1) & (fb_err < 1.0)
    if ok.sum() < 8:
        return None
    # tight RANSAC threshold: scene motion modes (background vs moving
    # foreground / parallax layers) sit a few px apart with sub-px
    # spread each; the default 3 px threshold merges them into one
    # consensus set and the fit splits the difference (absorbing the
    # offset into a fake scale term). 1 px isolates the majority mode.
    kw = dict(method=cv2.RANSAC, ransacReprojThreshold=1.0)
    if full:
        m, _ = cv2.estimateAffine2D(pts[ok], nxt[ok], **kw)
    else:
        m, _ = cv2.estimateAffinePartial2D(pts[ok], nxt[ok], **kw)
    return m


def interframe_transforms(
    frames: np.ndarray, return_tracked_fraction: bool = False
):
    """Affine transforms between consecutive frames.

    Frames where tracking fails reuse the PREVIOUS transform
    (constant-velocity hold): substituting identity would inject a fake
    full stop — a high-frequency step in the trajectory — and penalize
    the stability score for a metrology failure rather than real motion.

    The hold means a wholly untrackable clip (degenerate/featureless
    output) yields held transforms and would score as perfectly stable;
    ``return_tracked_fraction=True`` additionally returns the fraction
    of frame pairs that actually tracked so callers can distinguish
    "stable" from "unmeasurable" (``stability_report`` exposes it).
    """
    out: List[np.ndarray] = []
    tracked = 0
    last = np.eye(2, 3, dtype=np.float32)
    for i in range(len(frames) - 1):
        m = _track_affine(frames[i], frames[i + 1])
        if m is not None:
            last = m
            tracked += 1
        out.append(last)
    if return_tracked_fraction:
        return out, (tracked / len(out) if out else 0.0)
    return out


def stability_score(
    frames: np.ndarray,
    band: Tuple[int, int] = (1, 6),
    transforms: Optional[List[np.ndarray]] = None,
) -> float:
    """Low-frequency energy ratio of the motion trajectories.

    ``band`` is the half-open rfft-bin range counted as "low frequency"
    (default bins 1..5 = the literature's 2nd-6th components protocol).

    PROTOCOL CAVEAT: the published band comes from long trajectories.
    On a T-frame clip the rfft has T//2+1 bins, so for short clips
    (e.g. 32 frames -> 17 bins) the fixed 5-bin band spans a third of
    the spectrum and inflates scores — for the unstable input, the GT
    ceiling, and the output alike, so *comparisons* on equal-length
    clips remain meaningful, but absolute values are only comparable
    across equal clip lengths.  For protocol-faithful absolute numbers
    use clips of >= 200 frames (where the band is <= 5% of the
    spectrum).

    ``transforms`` accepts precomputed ``interframe_transforms(frames)``
    so a report can track each clip once.
    """
    ms = transforms if transforms is not None else interframe_transforms(frames)
    if not ms:
        return 1.0
    # accumulate translation + rotation paths
    tx = np.cumsum([m[0, 2] for m in ms])
    ty = np.cumsum([m[1, 2] for m in ms])
    rot = np.cumsum([np.arctan2(m[1, 0], m[0, 0]) for m in ms])
    lo, hi = band

    def ratio(path: np.ndarray) -> float:
        spec = np.abs(np.fft.rfft(path - path.mean())) ** 2
        total = spec[1:].sum()
        if total <= 1e-12:
            return 1.0
        return float(spec[lo:hi].sum() / total)

    return float(np.mean([ratio(tx), ratio(ty), ratio(rot)]))


def jitter_rms_px(
    frames: np.ndarray,
    smooth_frames: int = 9,
    transforms: Optional[List[np.ndarray]] = None,
) -> float:
    """RMS residual translation (px) after moving-average path smoothing.

    A protocol-independent complement to ``stability_score``: the
    spectral score saturates on long panning clips (a pan ramp
    concentrates nearly all trajectory energy in the lowest bins, so
    stabilized/unstable/GT all score ~0.9+ and the band ratio loses
    dynamic range).  The RMS
    deviation of the tracked camera path from its ``smooth_frames``-wide
    moving average measures the shake amplitude directly, in pixels,
    independent of clip length or pan rate.  Lower is better; a GT
    stable clip sits near the tracker noise floor (<~1 px).

    Clips too short to separate trend from jitter (fewer than 3 tracked
    inter-frame transforms) return ``nan`` — "unmeasured", which is not
    the same claim as 0.0 ("measured, no jitter").
    """
    ms = transforms if transforms is not None else interframe_transforms(frames)
    if not ms:
        return float("nan")
    k = max(3, int(smooth_frames) | 1)  # odd window
    vals = []
    for path in (
        np.cumsum([m[0, 2] for m in ms]),
        np.cumsum([m[1, 2] for m in ms]),
    ):
        # on clips shorter than the window, shrink it to the largest odd
        # width that fits (>= 3) so the semantics stay "residual from a
        # local moving average" — the old raw-variance fallback charged a
        # pan ramp entirely to jitter, the exact trend bias the
        # interior-only branch exists to avoid
        k_eff = min(k, len(path) if len(path) % 2 else len(path) - 1)
        if k_eff < 3:
            # 1-2 samples cannot separate trend from jitter: the clip is
            # unmeasured, not jitter-free
            vals.append(float("nan"))
            continue
        # interior-only residual ('valid' convolution): edge padding
        # would bias the smooth path by ~slope*k/4 at the clip ends,
        # charging a steep pan ramp with phantom jitter (measured:
        # a 6 px/frame GT pan read a constant 1.23 px floor)
        smooth = np.convolve(path, np.ones(k_eff) / k_eff, mode="valid")
        vals.append(
            np.mean((path[k_eff // 2 : k_eff // 2 + len(smooth)] - smooth) ** 2)
        )
    return float(np.sqrt(np.mean(vals)))


def cropping_ratio_and_distortion(
    original: np.ndarray, stabilized: np.ndarray
) -> Dict[str, float]:
    """Homography original->stabilized per frame: mean scale (cropping)
    and worst anisotropy (distortion)."""
    scales, anisos = [], []
    for o, s in zip(original, stabilized):
        m = _track_affine(o, s, full=True)
        if m is None:
            continue
        a = m[:2, :2]
        sv = np.linalg.svd(a, compute_uv=False)
        if sv[0] <= 1e-9:
            continue
        scales.append(float(np.sqrt(abs(np.linalg.det(a)) + 1e-12)))
        anisos.append(float(sv[1] / sv[0]))
    return {
        "cropping_ratio": float(np.mean(scales)) if scales else 1.0,
        "distortion_value": float(np.min(anisos)) if anisos else 1.0,
    }


def psnr(pred: np.ndarray, target: np.ndarray) -> float:
    """Peak signal-to-noise ratio in dB over [-1, 1] frames (peak 2.0).

    Fidelity metric for synthetic evaluations where a ground-truth
    stable clip exists (real DeepStab eval uses the trio above — GT and
    output differ by a global camera path, so PSNR is only meaningful
    against aligned targets)."""
    p = pred.astype(np.float32)
    t = target.astype(np.float32)
    mse = float(np.mean((p - t) ** 2))
    if mse <= 1e-12:
        return float("inf")
    return float(10.0 * np.log10(4.0 / mse))


def ssim(pred: np.ndarray, target: np.ndarray) -> float:
    """Mean structural similarity over frames ([-1, 1] range, 8x8 box
    window — the classic Wang et al. constants scaled to range 2)."""
    import cv2

    L = 2.0
    c1, c2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    vals = []
    for p, t in zip(
        pred.astype(np.float32), target.astype(np.float32)
    ):
        for ch in range(p.shape[-1]):
            x, y = p[..., ch], t[..., ch]
            mx = cv2.blur(x, (8, 8))
            my = cv2.blur(y, (8, 8))
            mxy = cv2.blur(x * y, (8, 8))
            mxx = cv2.blur(x * x, (8, 8))
            myy = cv2.blur(y * y, (8, 8))
            vx = mxx - mx * mx
            vy = myy - my * my
            cxy = mxy - mx * my
            s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
                (mx * mx + my * my + c1) * (vx + vy + c2)
            )
            vals.append(float(s.mean()))
    return float(np.mean(vals)) if vals else 1.0


def stability_report(
    stabilized: np.ndarray, original: Optional[np.ndarray] = None
) -> Dict[str, float]:
    """Full metric report; cropping/distortion require the original.

    ``tracked_pair_fraction`` reports how many consecutive-frame pairs
    of the stabilized clip actually tracked; near 0 means the stability
    numbers describe the constant-velocity hold, not the video (a
    degenerate all-black output would otherwise read as perfectly
    stable).  Treat scores with a fraction below ~0.5 as unmeasured.
    """
    ms, tracked_frac = interframe_transforms(
        stabilized, return_tracked_fraction=True
    )
    report = {
        "stability_score": stability_score(stabilized, transforms=ms),
        "jitter_rms_px": jitter_rms_px(stabilized, transforms=ms),
        "tracked_pair_fraction": float(tracked_frac),
    }
    if original is not None:
        ms_o = interframe_transforms(original)
        report["original_stability_score"] = stability_score(
            original, transforms=ms_o
        )
        report["original_jitter_rms_px"] = jitter_rms_px(
            original, transforms=ms_o
        )
        report.update(
            cropping_ratio_and_distortion(original, stabilized)
        )
    return report


def fidelity_report(
    stabilized: np.ndarray, ground_truth: np.ndarray
) -> Dict[str, float]:
    """PSNR/SSIM against an ALIGNED ground-truth stable clip (synthetic
    evaluations; see ``psnr`` for why real DeepStab uses the trio)."""
    return {
        "psnr_db": psnr(stabilized, ground_truth),
        "ssim": ssim(stabilized, ground_truth),
    }

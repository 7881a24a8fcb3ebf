"""DeepStab training data from video files on disk: a copy of the JAX
package's ``data/deepstab.py``, on the port's own ``video_io``,
``synthetic`` and ``prefetch``.

DeepStab is synchronized stable/unstable video pairs captured with a
dual-camera rig.  Layout expected::

    <data_root>/<unstable_dir>/<name>.avi
    <data_root>/<stable_dir>/<name>.avi      (same basename = a pair)

A sample is the unstable temporal stack around frame t for two
consecutive time steps (t, t+1: the temporal-loss pair) plus the
ground-truth stable frames, with one shared random scale jitter
(resize), crop and optional horizontal flip.  Frames are decoded on the
host by OpenCV with per-video capture reuse and stay **uint8** up to the
device; ``train.step`` normalises them there.  ``num_decode_threads``
worker threads decode the samples of a batch (cv2 releases the GIL
while it decodes), and the batches flow through a bounded queue.

For the same tree and seed, the batches are bitwise equal to the JAX
package's: both draw the same numbers from one numpy ``Generator`` in
the same order and run the same host operations.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from pwstablenet_tpu_torch.config import DataConfig
from pwstablenet_tpu_torch.data import video_io
from pwstablenet_tpu_torch.data.prefetch import Prefetcher


class _VideoCache:
    """Sequential-friendly frame reader with capture and position reuse.

    Thread-safe: a per-video lock serialises access to the capture, so
    decode threads can work on different videos at once."""

    def __init__(self, path: str, num_frames: Optional[int] = None):
        cv2 = video_io._cv2()
        self._cv2 = cv2
        self.path = path
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise FileNotFoundError(path)
        if num_frames is not None and num_frames > 0:
            # the dataset probed every pair at construction: reuse that
            # count, so a broken-header video is scanned once
            self.num_frames = num_frames
        else:
            self.num_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
            if self.num_frames <= 0:
                # broken header: the decode-scan count is what can be read
                self.num_frames = _probe_frame_count(path)
        self._pos = 0
        self.lock = threading.Lock()

    def read(self, t: int) -> np.ndarray:
        if t != self._pos:
            self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, t)
            self._pos = t
        ok, bgr = self._cap.read()
        if not ok:
            raise IOError(f"failed to read frame {t} of {self.path}")
        self._pos = t + 1
        return video_io._to_uint8_rgb(bgr)

    def read_range(self, lo: int, hi: int) -> List[np.ndarray]:
        with self.lock:
            return [self.read(t) for t in range(lo, hi)]


def _probe_frame_count(path: str) -> int:
    """Frame count from the container header, without decoding; a header
    count <= 0 falls back to a ``grab()`` scan, so a decodable pair is not
    dropped at dataset construction."""
    cv2 = video_io._cv2()
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise FileNotFoundError(path)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if n > 0:
            return n
        n = 0
        while cap.grab():
            n += 1
        return n
    finally:
        cap.release()


class DeepStabDataset:
    """Pair index and sampler.

    ``temporal_center``: position of the current frame inside the stack
    (None = centred; ``temporal_window - 1`` = causal mode; match
    ``ModelConfig.temporal_center``).
    """

    def __init__(self, cfg: DataConfig, temporal_window: int,
                 temporal_center: Optional[int] = None):
        self.cfg = cfg
        self.window = temporal_window
        self.center = (
            temporal_window // 2 if temporal_center is None else temporal_center
        )
        if not 0 <= self.center < temporal_window:
            raise ValueError(
                f"temporal_center must be in [0, {temporal_window}), "
                f"got {self.center}"
            )
        unstable_root = os.path.join(cfg.data_root, cfg.unstable_dir)
        stable_root = os.path.join(cfg.data_root, cfg.stable_dir)
        if not os.path.isdir(unstable_root):
            raise FileNotFoundError(f"DeepStab unstable dir not found: {unstable_root}")
        names = sorted(
            n for n in os.listdir(unstable_root)
            if os.path.exists(os.path.join(stable_root, n))
        )
        if not names:
            raise FileNotFoundError(f"no stable/unstable pairs under {cfg.data_root}")
        all_pairs: List[Tuple[str, str]] = [
            (os.path.join(unstable_root, n), os.path.join(stable_root, n))
            for n in names
        ]
        # frame counts are checked here (header reads only), so a
        # too-short pair is skipped loudly at construction and not met at
        # a random step; an empty remainder raises
        min_frames = self._min_frames_needed()
        self.pairs: List[Tuple[str, str]] = []
        self._frame_counts: Dict[str, int] = {}
        for u_path, s_path in all_pairs:
            nu = _probe_frame_count(u_path)
            ns = _probe_frame_count(s_path)
            self._frame_counts[u_path] = nu
            self._frame_counts[s_path] = ns
            n = min(nu, ns)
            if n < min_frames:
                print(
                    f"pwstablenet: skipping video pair "
                    f"{os.path.basename(u_path)!r}: only {n} frames; "
                    f"temporal_window={self.window} with frame_stride="
                    f"{cfg.frame_stride} needs at least {min_frames}",
                    file=sys.stderr,
                )
                continue
            self.pairs.append((u_path, s_path))
        if not self.pairs:
            raise ValueError(
                f"all {len(all_pairs)} video pairs under {cfg.data_root} "
                f"are shorter than the {min_frames} frames needed by "
                f"temporal_window={self.window} / frame_stride="
                f"{cfg.frame_stride}"
            )
        self._caches: Dict[str, _VideoCache] = {}
        self._lock = threading.Lock()

    def _min_frames_needed(self) -> int:
        """Minimum pair length for ``sample`` to have a centre to draw."""
        stride = self.cfg.frame_stride
        past = self.center
        future = self.window - 1 - self.center
        return past * stride + (future + 1) * stride + 2

    def _cache(self, path: str) -> _VideoCache:
        with self._lock:
            if path not in self._caches:
                self._caches[path] = _VideoCache(
                    path, num_frames=self._frame_counts.get(path)
                )
            return self._caches[path]

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """One training sample (unbatched): stacks (2, H, W, T*3) and
        stable (2, H, W, 3), uint8.  Draws, in order: the pair, t, the
        scale, y0, x0 and, when ``random_flip`` is set, the flip."""
        cfg = self.cfg
        past = self.center
        future = self.window - 1 - self.center
        stride = cfg.frame_stride
        u_path, s_path = self.pairs[int(rng.integers(len(self.pairs)))]
        u, s = self._cache(u_path), self._cache(s_path)
        n = min(u.num_frames, s.num_frames)
        lo_need = past * stride
        hi_need = (future + 1) * stride + 1
        if n <= lo_need + hi_need:
            # pairs are filtered at construction; a truncated re-open
            # could still land here
            raise ValueError(
                f"video pair {os.path.basename(u_path)!r} has only {n} "
                f"frames; temporal_window={self.window} with "
                f"frame_stride={stride} needs at least {lo_need + hi_need + 1}"
            )
        t = int(rng.integers(lo_need, n - hi_need))

        # decode the union of the frames both time steps need
        span = [t + k + j * stride for k in range(2) for j in range(-past, future + 1)]
        lo, hi = min(span), max(span) + 1
        u_frames = dict(zip(range(lo, hi), u.read_range(lo, hi)))
        with s.lock:
            s_t = s.read(t)
            s_t1 = s.read(t + 1)

        ch, cw = cfg.crop_size
        H, W = s_t.shape[:2]
        # one random scale per sample, bounded below so the crop fits
        smin, smax = cfg.resize_scale_range
        smin = max(smin, ch / H, cw / W)
        smax = max(smax, smin)
        scale = float(rng.uniform(smin, smax))
        rh, rw = max(int(round(H * scale)), ch), max(int(round(W * scale)), cw)
        y0 = int(rng.integers(0, rh - ch + 1))
        x0 = int(rng.integers(0, rw - cw + 1))
        flip = cfg.random_flip and bool(rng.integers(2))
        cv2 = video_io._cv2()

        def prep(img: np.ndarray) -> np.ndarray:
            if (rh, rw) != (H, W):
                img = cv2.resize(img, (rw, rh), interpolation=cv2.INTER_AREA)
            img = img[y0 : y0 + ch, x0 : x0 + cw]
            return img[:, ::-1] if flip else img

        stacks = np.zeros((2, ch, cw, self.window * 3), np.uint8)
        stable = np.zeros((2, ch, cw, 3), np.uint8)
        for k in range(2):
            window = [prep(u_frames[t + k + j * stride]) for j in range(-past, future + 1)]
            stacks[k] = np.concatenate(window, axis=-1)
        stable[0] = prep(s_t)
        stable[1] = prep(s_t1)
        return {"stacks": stacks, "stable": stable}


def batch_iterator(
    dataset: DeepStabDataset,
    batch_size: int,
    seed: int = 0,
    prefetch_depth: Optional[int] = None,
) -> Prefetcher:
    """Endless uint8 batches ``{"stacks": (B, 2, H, W, T*3), "stable":
    (B, 2, H, W, 3)}``, made on a background thread.

    ``DataConfig.num_decode_threads`` workers decode the samples of a
    batch at once; with more than one, one child seed a sample is drawn
    on the generator's thread first, so the batches do not depend on the
    pool's scheduling.  ``close()`` the returned ``Prefetcher`` to stop
    its thread and shut the worker pool down.
    """
    depth = prefetch_depth or dataset.cfg.prefetch_depth
    n_threads = max(int(dataset.cfg.num_decode_threads), 1)

    def stack(samples):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def gen():
        rng = np.random.default_rng(seed)
        if n_threads == 1:
            while True:
                yield stack([dataset.sample(rng) for _ in range(batch_size)])
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(n_threads) as pool:
                while True:
                    rngs = [
                        np.random.default_rng(int(rng.integers(1 << 62)))
                        for _ in range(batch_size)
                    ]
                    yield stack(list(pool.map(dataset.sample, rngs)))

    return Prefetcher(gen(), depth=depth)


def write_synthetic_deepstab(
    root: str,
    num_pairs: int = 2,
    frames: int = 40,
    height: int = 288,
    width: int = 384,
    seed: int = 0,
    rich: bool = False,
    curriculum: bool = False,
    **clip_kwargs,
) -> None:
    """Write a small synthetic DeepStab-shaped dataset of MJPG ``.avi``
    pairs (for tests and training without the real download).

    ``rich=True`` enables the full scene model (``data.synthetic.RICH``)
    with per-pair shake and pan diversity; other keyword arguments pass
    through to ``synthetic_pair_clip``.

    ``curriculum=True`` (implies ``rich``) widens the per-pair draws:
    shake U(3, 16) px, pan U(0.3, 2.5) px a frame, 1-4 occluders and
    exposure steps U(0.5, 2.0).  Train on it with
    ``pixel_loss_mode="mean_matched"``: plain L1 on exposure-stepped data
    teaches the model to explain brightness with geometry.  The draws
    always consume the stream, also for keys the caller set.
    """
    from pwstablenet_tpu_torch.data.synthetic import RICH, synthetic_pair_clip

    if curriculum:
        rich = True
    user_keys = frozenset(clip_kwargs)  # explicit kwargs beat the draws
    if rich:
        clip_kwargs = {**RICH, **clip_kwargs}
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "stable"), exist_ok=True)
    os.makedirs(os.path.join(root, "unstable"), exist_ok=True)
    for i in range(num_pairs):
        kw = dict(clip_kwargs)
        if curriculum:
            for key, draw in (
                ("shake_px", float(rng.uniform(3.0, 16.0))),
                ("pan_px", float(rng.uniform(0.3, 2.5))),
                ("num_occluders", int(rng.integers(1, 5))),
                ("exposure_steps", float(rng.uniform(0.5, 2.0))),
            ):
                if key not in user_keys:
                    kw[key] = draw
        elif rich:
            kw.setdefault("shake_px", float(rng.uniform(3.0, 9.0)))
            kw.setdefault("pan_px", float(rng.uniform(0.3, 1.8)))
        s, u = synthetic_pair_clip(frames, height, width, seed=seed + i, **kw)
        video_io.write_video(os.path.join(root, "stable", f"{i:02d}.avi"), s, 30.0, "MJPG")
        video_io.write_video(os.path.join(root, "unstable", f"{i:02d}.avi"), u, 30.0, "MJPG")

"""Host-side video decode and encode through OpenCV's Python bindings: a
copy of the JAX package's ``data/video_io.py`` (its ``Prefetcher`` is
``data.prefetch.Prefetcher`` here).

Frames travel host<->device as **uint8 RGB** by default, the decoder's
own dtype, and are normalised to [-1, 1] on the device (``ops.pixels``):
a quarter of the host->device bytes of float32.  ``dtype=np.float32``
is still accepted for callers that want host-side floats.

``cv2`` is imported when a function needs it: a machine without OpenCV
imports this module, and each function raises there when called.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError:
        raise RuntimeError("OpenCV (cv2) is required for video I/O") from None
    return cv2


def probe_video(path: str) -> Tuple[float, int, int]:
    """(fps, height, width) of a video file, without decoding it."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    cap.release()
    return fps, h, w


def read_video(
    path: str, max_frames: int = -1, dtype=np.float32
) -> Tuple[np.ndarray, float]:
    """Decode a whole video -> (frames (T, H, W, 3) RGB, fps).

    dtype float32: values in [-1, 1]; dtype uint8: raw 0..255 (the
    device-transport format)."""
    cv2 = _cv2()
    conv = _to_uint8_rgb if np.dtype(dtype) == np.uint8 else _to_float
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path!r}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    while max_frames < 0 or len(frames) < max_frames:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(conv(bgr))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path!r}")
    return np.stack(frames), float(fps)


def iter_video(
    path: str, chunk: int, dtype=np.float32
) -> Iterator[np.ndarray]:
    """Stream a video in chunks of ``chunk`` frames (the last may be
    short).  Opens the file at once, so a missing file raises here."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path!r}")
    return _iter_chunks(cap, chunk, dtype)


def _iter_chunks(cap, chunk: int, dtype) -> Iterator[np.ndarray]:
    conv = _to_uint8_rgb if np.dtype(dtype) == np.uint8 else _to_float
    buf = []
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            buf.append(conv(bgr))
            if len(buf) == chunk:
                yield np.stack(buf)
                buf = []
    finally:
        cap.release()
    if buf:
        yield np.stack(buf)


def write_video(
    path: str, frames: np.ndarray, fps: float = 30.0, codec: str = "mp4v"
) -> None:
    """Encode (T, H, W, 3) RGB frames, uint8 or float [-1, 1], to a video
    file."""
    cv2 = _cv2()
    t, h, w, _ = frames.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cannot open video writer for {path!r}")
    for f in frames:
        writer.write(_to_uint8_bgr(f))
    writer.release()


class VideoWriterStream:
    """Incremental encoder for streaming pipelines."""

    def __init__(self, path: str, fps: float, size_hw: Tuple[int, int],
                 codec: str = "mp4v"):
        cv2 = _cv2()
        h, w = size_hw
        self._writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps, (w, h))
        if not self._writer.isOpened():
            raise RuntimeError(f"cannot open video writer for {path!r}")

    def write(self, frames: np.ndarray) -> None:
        for f in frames:
            self._writer.write(_to_uint8_bgr(f))

    def close(self) -> None:
        self._writer.release()


def _to_float(bgr: np.ndarray) -> np.ndarray:
    rgb = bgr[..., ::-1].astype(np.float32)
    return rgb / 127.5 - 1.0


def _to_uint8_rgb(bgr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(bgr[..., ::-1])


def _to_uint8_bgr(frame: np.ndarray) -> np.ndarray:
    if frame.dtype == np.uint8:  # already the transport format: swap only
        return frame[..., ::-1]
    rgb = np.clip((frame + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return rgb[..., ::-1]

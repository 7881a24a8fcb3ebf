"""ctypes bindings for the native C++ video runtime (``csrc/video_io.cpp``):
a copy of the JAX package's ``data/native_io.py``.

The runtime keeps decode and the colour conversion in C++, with a decode
thread and a bounded chunk queue, and hands Python **uint8 RGB** chunks,
the device-transport format.  The library is built at first use with
``g++`` against the system's OpenCV 4 into ``_build/`` beside the
package (listed in ``.gitignore``), named by a hash of the source and
the command, so a changed source rebuilds.  Nothing is built when this
module is imported; a build that fails makes ``available()`` false, and
``build()`` raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from typing import Iterator, Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "video_io.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-I/usr/include/opencv4", "-shared")
LIBS = ("-lopencv_videoio", "-lopencv_imgproc", "-lopencv_core", "-lpthread")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpwst_video_io_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile the runtime if it is not built yet; returns ``{"path",
    "seconds"}`` (``seconds`` 0 when it was already there).  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    path = _library_path()
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS],
            capture_output=True, text=True, timeout=240,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return {"path": path, "seconds": time.perf_counter() - t0}


def load() -> ctypes.CDLL:
    """Build (if needed) and load the runtime, with its signatures set."""
    lib = ctypes.CDLL(build()["path"])
    lib.vd_open.restype = ctypes.c_void_p
    lib.vd_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.vd_info.restype = None
    lib.vd_info.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.vd_next_u8.restype = ctypes.c_int
    lib.vd_next_u8.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.vd_close.restype = None
    lib.vd_close.argtypes = [ctypes.c_void_p]
    lib.ve_open.restype = ctypes.c_void_p
    lib.ve_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double, ctypes.c_int, ctypes.c_int,
    ]
    lib.ve_write_u8.restype = ctypes.c_int
    lib.ve_write_u8.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.ve_close.restype = None
    lib.ve_close.argtypes = [ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> Optional[ctypes.CDLL]:
    """The loaded runtime, or None when it cannot be built or loaded
    (remembered for the life of the process)."""
    try:
        return load()
    except (OSError, RuntimeError):
        return None


def available() -> bool:
    return _library() is not None


def _require() -> ctypes.CDLL:
    lib = _library()
    if lib is None:
        raise RuntimeError("native video runtime unavailable")
    return lib


class NativeDecoder:
    """Streaming decoder: chunks of (n, H, W, 3) uint8 RGB."""

    def __init__(self, path: str, chunk_frames: int = 8, queue_depth: int = 2):
        lib = _require()
        self._lib = lib
        self._h = lib.vd_open(path.encode(), int(chunk_frames), int(queue_depth))
        if not self._h:
            raise FileNotFoundError(f"cannot open video {path!r}")
        self.chunk_frames = chunk_frames
        h = ctypes.c_int()
        w = ctypes.c_int()
        fps = ctypes.c_double()
        n = ctypes.c_int64()
        lib.vd_info(self._h, h, w, fps, n)
        self.height, self.width = h.value, w.value
        self.fps = fps.value or 30.0
        self.total_frames = n.value

    def __iter__(self) -> Iterator[np.ndarray]:
        while self._h:
            buf = np.empty((self.chunk_frames, self.height, self.width, 3), np.uint8)
            got = self._lib.vd_next_u8(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self.chunk_frames,
            )
            if got == 0:
                return
            yield buf[:got]

    def close(self) -> None:
        if self._h:
            self._lib.vd_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeEncoder:
    """Streaming encoder for uint8 RGB frames (float [-1, 1] accepted
    and converted on the host)."""

    def __init__(self, path: str, fps: float, size_hw: Tuple[int, int],
                 codec: str = "mp4v"):
        lib = _require()
        self._lib = lib
        h, w = size_hw
        self._size = (h, w)
        self._h = lib.ve_open(path.encode(), codec.encode()[:4], float(fps), int(h), int(w))
        if not self._h:
            raise RuntimeError(f"cannot open video writer for {path!r}")

    def write(self, frames: np.ndarray) -> None:
        if frames.dtype != np.uint8:
            frames = np.clip(
                (frames.astype(np.float32) + 1.0) * 127.5, 0, 255
            ).astype(np.uint8)
        if frames.shape[1:] != (*self._size, 3):
            raise ValueError(
                f"frames of shape {frames.shape[1:]} for an encoder of "
                f"{(*self._size, 3)}"
            )
        frames = np.ascontiguousarray(frames)
        self._lib.ve_write_u8(
            self._h, frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            frames.shape[0],
        )

    def close(self) -> None:
        if self._h:
            self._lib.ve_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

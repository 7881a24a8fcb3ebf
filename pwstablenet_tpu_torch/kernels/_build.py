"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface; they are compiled
with ``nvcc`` into one shared library on first use and loaded with
``ctypes``.  The library lands in ``_build/`` beside the package (listed
in ``.gitignore``), named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads at once.  Nothing
here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = ("grid_sample.cu",)
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# -fmad=false: no fused multiply-add contraction, so the kernels round
# each step as their plain PyTorch versions do.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # image, grid, out, B, H, W, C, Ho, Wo, zeros, align_corners, stream
    "pwst_grid_sample_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # image, grid, out, B, H, W, Ho, Wo, align_corners, stream
    "pwst_grid_sample_packed_u8": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # image, grid, cot, out, B, H, W, C, Ho, Wo, zeros, align_corners, stream
    "pwst_grid_sample_grad_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from csrc/ on a "
            "machine with the CUDA toolkit"
        )
    return path


def _library_path(csrc: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpwst_kernels_{h.hexdigest()[:16]}.so")


def build(csrc: str = CSRC_DIR) -> dict:
    """Compile the kernel library from the sources in ``csrc`` (this
    package's by default; another tree's ``csrc`` with the same C
    interface, for an A/B) if it is not built yet.

    Returns ``{"path", "seconds", "log"}``: ``seconds`` is 0 and ``log``
    empty when the library was already there."""
    path = _library_path(csrc)
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    srcs = [os.path.join(csrc, s) for s in _SOURCES]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return {"path": path, "seconds": seconds, "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def library(csrc: str = CSRC_DIR) -> ctypes.CDLL:
    """The loaded kernel library of ``csrc`` (built on first call)."""
    lib = ctypes.CDLL(build(csrc)["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib

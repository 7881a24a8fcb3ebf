"""Streaming warp-field storage: a copy of the JAX package's
``data/warp_fields.py``, so the archives of the two packages are
interchangeable in both directions.

``stabilize_video`` emits one flow field per frame at model resolution.
Buffering them for one final ``np.savez`` would hold O(video length) in
host memory (~0.5 MB a frame in float32, ~54 GB for an hour at 30 fps,
whatever the video's resolution).  ``WarpFieldWriter`` instead streams
chunks into a stored (deflate-free) ``.npz``: each chunk becomes an
``arr_NNNNN.npy`` zip member, so memory stays O(chunk).

``load_warp_fields`` reads both layouts: chunked files from this
writer and legacy single-key ``warp_fields`` archives.  numpy stores
bfloat16 fields (``ml_dtypes.bfloat16``) as raw 2-byte voids; the loader
gives them back as bfloat16, where the JAX package's loader returns the
voids.
"""

from __future__ import annotations

import io
import zipfile

import numpy as np


class WarpFieldWriter:
    """Incrementally write flow chunks to an ``.npz``-compatible file."""

    def __init__(self, path: str):
        self._zip = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED)
        self._count = 0
        self.frames = 0

    def write(self, flows: np.ndarray) -> None:
        buf = io.BytesIO()
        np.lib.format.write_array(
            buf, np.ascontiguousarray(flows), allow_pickle=False
        )
        self._zip.writestr(f"arr_{self._count:05d}.npy", buf.getvalue())
        self._count += 1
        self.frames += flows.shape[0]

    def close(self) -> None:
        if self._zip is not None:
            self._zip.close()
            self._zip = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def bfloat16() -> np.dtype:
    """numpy's bfloat16, from ``ml_dtypes`` (the dtype the JAX package
    returns bfloat16 warp fields in), imported only when asked for."""
    try:
        import ml_dtypes
    except ImportError:
        raise RuntimeError(
            "bfloat16 warp fields need the ml_dtypes package (numpy has no "
            "bfloat16); install it or use float32 or float16 fields"
        ) from None
    return np.dtype(ml_dtypes.bfloat16)


def load_warp_fields(path: str) -> np.ndarray:
    """Concatenate a warp-field archive (chunked or legacy layout)."""
    with np.load(path) as data:
        if "warp_fields" in data:
            flows = data["warp_fields"]
        else:
            keys = sorted(k for k in data.files if k.startswith("arr_"))
            if not keys:
                raise ValueError(f"{path!r} holds no warp fields")
            flows = np.concatenate([data[k] for k in keys])
    if flows.dtype == np.dtype("V2"):  # how numpy saves bfloat16
        flows = flows.view(bfloat16())
    return flows

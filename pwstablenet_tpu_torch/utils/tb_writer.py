"""Dependency-free TensorBoard scalar summary writer: a copy of the JAX
package's ``utils/tb_writer.py`` (the same bytes on disk).

Writes standard ``events.out.tfevents.*`` files that TensorBoard (and
anything else that reads TFRecord event files) can open — without
TensorFlow, tensorboardX, or protobuf installed.  The two formats
involved are small and stable, so they are encoded by hand:

- **TFRecord framing**: ``uint64 length | uint32 masked_crc32c(length)
  | payload | uint32 masked_crc32c(payload)`` with the Castagnoli CRC
  and TensorFlow's rotate-and-add masking.
- **``tensorflow.Event`` protobuf**: only the fields TensorBoard needs
  for scalars — ``wall_time`` (1, double), ``step`` (2, int64),
  ``file_version`` (3, string), ``summary`` (5) holding repeated
  ``Summary.Value{tag (1, string), simple_value (2, float)}``.

The JSONL scalar stream (``train/loop.py``) is the primary log; this
writer is its optional dashboard-compatible mirror
(``TrainConfig.tb_log_dir``).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Mapping, Optional

# ---------------------------------------------------------------------
# crc32c (Castagnoli), table-driven, reflected polynomial 0x82F63B78
# ---------------------------------------------------------------------

_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TensorFlow's TFRecord CRC masking (rotate right 15, add const)."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------
# minimal protobuf wire-format encoders
# ---------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _scalar_event(step: int, tag: str, value: float, wall_time: float):
    summary_value = _field_bytes(1, tag.encode("utf-8")) + _field_float(
        2, float(value)
    )
    summary = _field_bytes(1, summary_value)
    return (
        _field_double(1, wall_time)
        + _field_varint(2, int(step))
        + _field_bytes(5, summary)
    )


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


# ---------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------


class SummaryWriter:
    """Append scalar summaries to a TensorBoard event file.

    >>> w = SummaryWriter("runs/exp1")
    >>> w.add_scalars({"loss_g": 0.5, "loss_d": 0.7}, step=100)
    >>> w.close()
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}{filename_suffix}"
        )
        self.path = os.path.join(logdir, name)
        self._file = open(self.path, "ab", buffering=0)
        self._write_record(_version_event(time.time()))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._file.write(
            header
            + struct.pack("<I", masked_crc32c(header))
            + payload
            + struct.pack("<I", masked_crc32c(payload))
        )

    def add_scalar(
        self, tag: str, value: float, step: int,
        wall_time: Optional[float] = None,
    ) -> None:
        self._write_record(
            _scalar_event(step, tag, value, wall_time or time.time())
        )

    def add_scalars(
        self, scalars: Mapping[str, float], step: int,
        wall_time: Optional[float] = None,
    ) -> None:
        t = wall_time or time.time()
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step, wall_time=t)

    def flush(self) -> None:
        os.fsync(self._file.fileno())

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------
# reader (used by tests to verify the format end-to-end; also handy for
# offline analysis without TensorBoard installed)
# ---------------------------------------------------------------------


def read_event_file(path: str):
    """Parse an event file written by :class:`SummaryWriter`.

    Returns a list of dicts: ``{"wall_time", "step", "file_version" |
    "scalars": {tag: value}}``.  Raises ``ValueError`` on CRC mismatch
    (both the length and payload CRCs are checked).
    """
    events = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                break
            (hcrc,) = struct.unpack("<I", f.read(4))
            if masked_crc32c(header) != hcrc:
                raise ValueError("length CRC mismatch")
            (length,) = struct.unpack("<Q", header)
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if masked_crc32c(payload) != pcrc:
                raise ValueError("payload CRC mismatch")
            events.append(_decode_event(payload))
    return events


def _decode_fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i : i + 8], i + 8
        elif wire == 5:
            val, i = buf[i : i + 4], i + 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val, i = buf[i : i + ln], i + ln
        else:  # pragma: no cover - not produced by the writer
            raise ValueError(f"unsupported wire type {wire}")
        yield num, wire, val


def _read_varint(buf: bytes, i: int):
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, i
        shift += 7


def _decode_event(payload: bytes) -> dict:
    ev: dict = {}
    for num, wire, val in _decode_fields(payload):
        if num == 1 and wire == 1:
            ev["wall_time"] = struct.unpack("<d", val)[0]
        elif num == 2 and wire == 0:
            ev["step"] = val
        elif num == 3 and wire == 2:
            ev["file_version"] = val.decode("utf-8")
        elif num == 5 and wire == 2:
            scalars = ev.setdefault("scalars", {})
            for vnum, vwire, vval in _decode_fields(val):
                if vnum == 1 and vwire == 2:
                    tag, simple = None, None
                    for inum, iwire, ival in _decode_fields(vval):
                        if inum == 1 and iwire == 2:
                            tag = ival.decode("utf-8")
                        elif inum == 2 and iwire == 5:
                            simple = struct.unpack("<f", ival)[0]
                    if tag is not None and simple is not None:
                        scalars[tag] = simple
    return ev

"""Dependency-free TensorBoard event writer, scalars and grayscale images
(the port's copy of ``bio_image_unet_tpu/utils/tboard.py``; numpy and zlib
only, so it runs where the ``tensorboard`` package is not installed).

The reference logs through torch's ``SummaryWriter``
(multi_output_unet/train.py:100-101,192,229,320-364); the event-file format
is written directly:

- **TFRecord framing** — each record is ``uint64 len | uint32
  masked_crc32c(len) | payload | uint32 masked_crc32c(payload)``.
- **Event protobuf** — hand-encoded (the schema is tiny and frozen):
  ``Event{1: wall_time double, 2: step int64, 3: file_version string,
  5: Summary}``; ``Summary{1: repeated Value}``; ``Value{1: tag string,
  2: simple_value float, 4: Image}``; ``Image{1: height, 2: width,
  3: colorspace, 4: png bytes}``.
- **PNG encoding** — minimal zlib-deflate grayscale encoder for
  ``add_image``.

TensorBoard reads the resulting ``events.out.tfevents.*`` files natively.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — table-driven; TFRecord uses the "masked" variant
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    # protobuf encodes negative ints as 10-byte two's-complement varints;
    # Python's arithmetic right shift on a negative n never reaches 0, so
    # mask to unsigned 64-bit first (also what protobuf does on the wire)
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _pb_str(field: int, v: str) -> bytes:
    return _pb_bytes(field, v.encode())


# ---------------------------------------------------------------------------
# minimal grayscale PNG encoder
# ---------------------------------------------------------------------------


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def encode_png_gray(img: np.ndarray) -> bytes:
    """uint8 (H, W) → PNG bytes (color type 0, 8-bit grayscale)."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class SummaryWriter:
    """API-compatible subset of torch's SummaryWriter: ``add_scalar``,
    ``add_image`` (grayscale (1, H, W) / (H, W) float or uint8), ``flush``,
    ``close``."""

    def __init__(self, log_dir: str = "./runs"):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._fh = open(os.path.join(log_dir, fname), "ab")
        self._event(_pb_double(1, time.time()) + _pb_str(3, "brain.Event:2"))

    def _event(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._fh.write(header + struct.pack("<I", _masked_crc(header))
                       + payload + struct.pack("<I", _masked_crc(payload)))

    def _summary_event(self, step: int, value: bytes) -> None:
        summary = _pb_bytes(1, value)
        self._event(_pb_double(1, time.time()) + _pb_int(2, int(step))
                    + _pb_bytes(5, summary))

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._summary_event(step, _pb_str(1, tag) + _pb_float(2, float(value)))

    def add_image(self, tag: str, img, step: int) -> None:
        """``img``: (H, W) or (1, H, W); float arrays are min-max scaled."""
        img = np.asarray(img)
        if img.ndim == 3:
            img = img[0]
        if img.dtype != np.uint8:
            lo, hi = float(img.min()), float(img.max())
            img = ((img - lo) / (hi - lo) * 255 if hi > lo
                   else np.zeros_like(img)).astype(np.uint8)
        h, w = img.shape
        image_pb = (_pb_int(1, h) + _pb_int(2, w) + _pb_int(3, 1)
                    + _pb_bytes(4, encode_png_gray(img)))
        self._summary_event(step, _pb_str(1, tag) + _pb_bytes(4, image_pb))

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

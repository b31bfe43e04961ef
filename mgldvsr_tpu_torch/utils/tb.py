"""TensorBoard event-file writer, dependency-free.

Counterpart of ``mgldvsr_tpu/utils/tb.py``, copied: writes standard
``events.out.tfevents.*`` files that TensorBoard reads, with scalars and
PNG image summaries, using nothing but the standard library, numpy and
zlib.

Format notes (both public, stable formats):
- TFRecord framing: uint64-LE length, masked crc32c of the length bytes,
  payload, masked crc32c of the payload. CRC is Castagnoli (0x82F63B78,
  reflected), masked as ``rotr15(crc) + 0xa282ead8``.
- Event / Summary protobufs hand-encoded (fields: Event.wall_time=1 double,
  Event.step=2 int64, Event.file_version=3 string, Event.summary=5 msg;
  Summary.value=1 repeated; Value.tag=1, Value.simple_value=2 float,
  Value.image=4 msg; Image.height=1, width=2, colorspace=3,
  encoded_image_string=4 bytes).
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

import numpy as np

# --- crc32c (Castagnoli, reflected) ----------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf encoding ----------------------------------------------


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _summary_scalar(tag: str, value: float) -> bytes:
    val = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
    return _f_bytes(1, val)  # Summary.value


def _summary_image(tag: str, png: bytes, h: int, w: int, c: int) -> bytes:
    img = (_f_varint(1, h) + _f_varint(2, w) + _f_varint(3, c)
           + _f_bytes(4, png))
    val = _f_bytes(1, tag.encode()) + _f_bytes(4, img)
    return _f_bytes(1, val)


def _event(step: Optional[int] = None, summary: Optional[bytes] = None,
           file_version: Optional[str] = None) -> bytes:
    out = _f_double(1, time.time())
    if step is not None:
        out += _f_varint(2, int(step))
    if file_version is not None:
        out += _f_bytes(3, file_version.encode())
    if summary is not None:
        out += _f_bytes(5, summary)
    return out


def _png_encode(img01: np.ndarray) -> bytes:
    """[H,W,C] or [H,W] float [0,1] -> PNG bytes (zlib, unfiltered rows)."""
    import zlib

    arr = (np.clip(img01, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(typ, data):
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


class TBEventWriter:
    """Append-only tfevents writer: ``scalar()`` and ``image()``."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}{filename_suffix}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write(_event(file_version="brain.Event:2"))

    def _write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int):
        self._write(_event(step, _summary_scalar(tag, value)))

    def scalars(self, metrics, step: int):
        for k, v in metrics.items():
            if np.ndim(v) == 0:
                self.scalar(k, float(v), step)

    def image(self, tag: str, img01: np.ndarray, step: int):
        """img01: [H,W,C] or [H,W] float [0,1]."""
        img01 = np.asarray(img01)
        h, w = img01.shape[:2]
        c = 1 if img01.ndim == 2 else img01.shape[2]
        png = _png_encode(img01)
        self._write(_event(step, _summary_image(tag, png, h, w, c)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()

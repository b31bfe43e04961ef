"""Read and write 8-bit RGB frames.

The JAX package reads and writes frames with OpenCV, which the card's
machine does not have. Here PIL is used when it imports; otherwise a small
PNG codec in numpy and ``zlib`` reads 8-bit gray, RGB and RGBA PNGs
(non-interlaced, all five row filters) and writes RGB PNGs. A JPEG needs
PIL: without it, reading one raises ``RuntimeError``.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> samples a pixel


def codec() -> str:
    """``"PIL"`` where it imports, else ``"png"`` (the numpy + zlib codec)."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return "png"
    return "PIL"


def read_frame(path: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB (a gray frame repeated, alpha dropped)."""
    if codec() == "PIL":
        from PIL import Image

        with Image.open(path) as img:
            return np.asarray(img.convert("RGB")).copy()
    if not path.lower().endswith(".png"):
        raise RuntimeError(f"{path}: only PNG frames can be read without PIL, which is not "
                           f"installed")
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_frame(path: str, rgb: np.ndarray, compression: int | None = None) -> None:
    """Write [H, W, 3] uint8 RGB; the format follows the extension with
    PIL, and is PNG without it. ``compression``: a PNG's zlib level, 0-9
    (default 6)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.shape}")
    if codec() == "PIL":
        from PIL import Image

        png = os.path.splitext(path)[1].lower() == ".png"
        Image.fromarray(rgb).save(path, **({"compress_level": compression}
                                           if png and compression is not None else {}))
        return
    if os.path.splitext(path)[1].lower() != ".png":
        raise RuntimeError(f"{path}: only PNG frames can be written without PIL, which is not "
                           f"installed")
    with open(path, "wb") as f:
        f.write(encode_png(rgb, 6 if compression is None else compression))


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit gray, RGB or RGBA non-interlaced PNG -> [H, W, 3] uint8 RGB."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace} (8-bit gray, RGB or RGBA, non-interlaced only)")
    ch = _CHANNELS[colour]
    stride = width * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum of each sample along the row
            cur = np.cumsum(line.reshape(width, ch), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: each pixel needs the one left of it
            cur = _unfilter_left(kind, line, prev, ch)
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = cur
        prev = cur.astype(np.int32)
    img = out.reshape(height, width, ch)
    if ch == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def _unfilter_left(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Average (3) or Paeth (4) filter of one row, one pixel
    (``bpp`` bytes) at a time."""
    cur = np.zeros_like(line)
    left = np.zeros(bpp, np.int32)
    up_left = np.zeros(bpp, np.int32)
    for x in range(0, line.size, bpp):
        up = prev[x:x + bpp]
        if kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        left = (line[x:x + bpp] + pred) & 0xFF
        cur[x:x + bpp] = left
        up_left = up
    return cur


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray, level: int = 6) -> bytes:
    """[H, W, 3] uint8 -> an 8-bit RGB PNG, every row unfiltered, deflated
    at zlib ``level``."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))

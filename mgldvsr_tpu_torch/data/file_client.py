"""File backends of the training data path, without OpenCV.

Counterpart of ``mgldvsr_tpu/data/file_client.py``: the disk backend and
the packed-record backend (one data file + a JSON index of [offset,
length] per key) with its maker, ``FileClient`` (the dispatch over the
two), and ``imfrombytes``, which decodes PNG bytes through
:mod:`mgldvsr_tpu_torch.io.frames` (other formats need PIL). The lmdb and
memcached backends are not ported: ``FileClient`` refuses them by name.
"""
from __future__ import annotations

import io
import json
import os
from typing import Dict

import numpy as np

from mgldvsr_tpu_torch.io.frames import codec, decode_png


class DiskBackend:
    def get(self, filepath: str) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()


class PackedBackend:
    """Keyed reads from a packed record file (``<root>.data`` +
    ``<root>.index.json`` mapping key -> [offset, length])."""

    def __init__(self, root: str):
        self._root = root
        with open(root + ".index.json") as f:
            self._index: Dict[str, list] = json.load(f)
        # positioned reads on a raw descriptor: concurrent readers share no
        # file position
        self._fd = os.open(root + ".data", os.O_RDONLY)

    def __getstate__(self):
        # a prefetch worker process opens its own descriptor
        return {"root": self._root, "index": self._index}

    def __setstate__(self, state):
        self._root, self._index = state["root"], state["index"]
        self._fd = os.open(self._root + ".data", os.O_RDONLY)

    def get(self, key: str) -> bytes:
        off, length = self._index[key]
        return os.pread(self._fd, length, off)

    def keys(self):
        return self._index.keys()

    def close(self):
        os.close(self._fd)


class PackedMaker:
    """Build a packed record file."""

    def __init__(self, root: str):
        self._root = root
        self._file = open(root + ".data", "wb")
        self._index: Dict[str, list] = {}
        self._off = 0

    def put(self, key: str, data: bytes):
        self._file.write(data)
        self._index[key] = [self._off, len(data)]
        self._off += len(data)

    def close(self):
        self._file.close()
        with open(self._root + ".index.json", "w") as f:
            json.dump(self._index, f)


class FileClient:
    """Backend dispatch: ``"disk"`` (default) or ``"packed"`` (``root=``)."""

    def __init__(self, backend: str = "disk", **kwargs):
        if backend == "disk":
            self._b = DiskBackend()
        elif backend == "packed":
            self._b = PackedBackend(**kwargs)
        elif backend in ("lmdb", "memcached"):
            raise ValueError(f"the {backend} backend is not ported; use 'disk' or 'packed'")
        else:
            raise ValueError(f"unknown io backend {backend!r}")
        self.backend = backend

    def get(self, key: str) -> bytes:
        return self._b.get(key)


def imfrombytes(content: bytes, flag: str = "color", float32: bool = False) -> np.ndarray:
    """Decode an image buffer as OpenCV's ``color`` flag does: [H, W, 3]
    uint8 BGR (alpha dropped, gray repeated); with ``float32`` scaled to
    [0, 1]."""
    if flag != "color":
        raise ValueError(f"only the 'color' flag is supported, got {flag!r}")
    if content[:8] == b"\x89PNG\r\n\x1a\n":
        rgb = decode_png(content)
    elif codec() == "PIL":
        from PIL import Image

        with Image.open(io.BytesIO(content)) as img:
            rgb = np.asarray(img.convert("RGB")).copy()
    else:
        raise RuntimeError("only PNG bytes can be decoded without PIL, which is not installed")
    img = np.ascontiguousarray(rgb[..., ::-1])
    if float32:
        img = img.astype(np.float32) / 255.0
    return img

"""File backends of the training data path, without OpenCV.

Counterpart of ``mgldvsr_tpu/data/file_client.py``: the disk backend, the
packed-record backend (one data file + a JSON index of [offset, length] per
key) with its maker, the lmdb and memcached backends (each imported only
when it is asked for; memcached also takes an injected client),
``FileClient`` (the dispatch over the four), and ``imfrombytes``, which
decodes PNG bytes through :mod:`mgldvsr_tpu_torch.io.frames` (other formats
need PIL).
"""
from __future__ import annotations

import io
import json
import os
from typing import Dict, Optional

import numpy as np

from mgldvsr_tpu_torch.io.frames import codec, decode_png


class DiskBackend:
    def get(self, filepath: str) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()


class LmdbBackend:
    def __init__(self, db_path: str, readonly: bool = True, lock: bool = False):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError("lmdb backend requested but the lmdb package is not installed; "
                              "use 'disk' or 'packed'") from e
        self._env = lmdb.open(db_path, readonly=readonly, lock=lock, readahead=False)

    def get(self, key: str) -> bytes:
        with self._env.begin(write=False) as txn:
            return bytes(txn.get(key.encode("ascii")))


class MemcachedBackend:
    """Memcached keyed reads. A ``client`` with a ``get(key)`` is used as
    given; otherwise the ``mc`` client is tried first, then ``pylibmc``.
    ``get`` returns the value's bytes and raises ``KeyError`` on a miss
    (the other backends' contract); a ``client`` or ``pylibmc`` value that
    is not bytes raises ``TypeError``."""

    def __init__(self, server_list_cfg: str = "", client_cfg: str = "",
                 sys_path: Optional[str] = None, client=None):
        if client is not None:
            self._get = self._checked(client.get)
            return
        if sys_path is not None:
            import sys

            sys.path.append(sys_path)
        try:
            import mc

            self._client = mc.MemcachedClient.GetInstance(server_list_cfg, client_cfg)
            self._buf = mc.pyvector()

            def _get(key: str) -> bytes:
                self._client.Get(key, self._buf)
                return mc.ConvertBuffer(self._buf)

            self._get = _get
            return
        except ImportError:
            pass
        try:
            import pylibmc
        except ImportError as e:
            raise ImportError("memcached backend requested but neither 'mc' nor 'pylibmc' is "
                              "installed; use 'disk', 'packed' or 'lmdb'") from e
        self._get = self._checked(
            pylibmc.Client([s for s in server_list_cfg.split(",") if s]).get)

    @staticmethod
    def _checked(get):
        def _get(key: str) -> bytes:
            # pylibmc gives None for a missing key and may unpickle a value
            val = get(key)
            if val is None:
                raise KeyError(key)
            if not isinstance(val, bytes):
                raise TypeError(f"memcached value for {key!r} is {type(val).__name__}, "
                                "expected raw bytes")
            return val

        return _get

    def get(self, key: str) -> bytes:
        return self._get(str(key))


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
    """Backend dispatch: ``"disk"`` (default), ``"packed"`` (``root=``),
    ``"lmdb"`` (``db_path=``) or ``"memcached"``."""

    def __init__(self, backend: str = "disk", **kwargs):
        if backend == "disk":
            self._b = DiskBackend()
        elif backend == "packed":
            self._b = PackedBackend(**kwargs)
        elif backend == "lmdb":
            self._b = LmdbBackend(**kwargs)
        elif backend == "memcached":
            self._b = MemcachedBackend(**kwargs)
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

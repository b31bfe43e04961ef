"""ctypes binding of the native clip loader (``src/clip_loader.cpp``).

Counterpart of ``mgldvsr_tpu/native/loader.py``. ``NativeClipLoader`` reads
a packed record file (``<root>.data`` + ``<root>.index.json``, as
:class:`~mgldvsr_tpu_torch.data.file_client.PackedMaker` writes it) and
serves decoded, cropped float32 BGR HWC clips from a C++ worker pool:
decode and crop run outside the GIL, beside the thread that feeds the
device. A loader pickles (into a prefetch worker process) as its file and
settings, and the worker opens its own.
"""
from __future__ import annotations

import ctypes
import functools
import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from mgldvsr_tpu_torch.native import build_native

STATUS = {0: "ok", 1: "read error", 2: "decode error", 3: "crop out of bounds",
          4: "bad record id", 5: "png codec not built (no png.h when the loader was compiled)",
          6: "jpeg codec not built (no jpeglib.h when the loader was compiled)"}
_CODEC_BITS = {"png": 1, "jpeg": 2}


@functools.cache
def _load_lib(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.mgld_codecs.restype = ctypes.c_int
    lib.mgld_codecs.argtypes = []
    lib.mgld_open.restype = ctypes.c_void_p
    lib.mgld_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.mgld_register.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.mgld_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int)]
    lib.mgld_submit.restype = ctypes.c_int64
    lib.mgld_submit.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.mgld_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.mgld_decode_one.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_float)]
    lib.mgld_close.argtypes = [ctypes.c_void_p]
    return lib


def compiled_codecs(path: str) -> tuple[str, ...]:
    """The codecs compiled into the library at ``path``."""
    bits = _load_lib(path).mgld_codecs()
    return tuple(name for name, bit in _CODEC_BITS.items() if bits & bit)


def _floats(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeClipLoader:
    """Keyed, threaded clip reads from a packed record image file.

    Each 8-bit value is divided by ``255.f``, numpy's
    ``x.astype(np.float32) / 255.0`` bit for bit, so the frames equal the
    Python decode's (the JAX package's loader multiplies by ``1 / 255.f``:
    one ulp apart at 126 of the 256 values). ``library``: an already built
    library to load (default:
    :func:`~mgldvsr_tpu_torch.native.build_native`'s)."""

    def __init__(self, root: str, num_threads: int = 4, library: str | None = None):
        self._settings = dict(root=root, num_threads=num_threads)
        self.library = library or build_native()
        self._lib = _load_lib(self.library)
        self._h = None
        with open(root + ".index.json") as f:
            index: Dict[str, list] = json.load(f)
        self._keys: Dict[str, int] = {}
        offs = np.empty(len(index), np.int64)
        lens = np.empty(len(index), np.int64)
        for i, (k, (off, length)) in enumerate(index.items()):
            self._keys[k] = i
            offs[i] = off
            lens[i] = length
        self._h = self._lib.mgld_open((root + ".data").encode(), int(num_threads))
        if not self._h:
            raise FileNotFoundError(root + ".data")
        self._lib.mgld_register(self._h, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(index))
        self._dims: Dict[int, Tuple[int, int]] = {}
        # the output buffers of jobs not yet fetched: they must outlive the job
        self._pending: Dict[int, np.ndarray] = {}

    def __getstate__(self):
        # a prefetch worker opens its own descriptor and pool, from the
        # library this process built
        return dict(self._settings, library=self.library)

    def __setstate__(self, state):
        self.__init__(**state)

    @property
    def codecs(self) -> tuple[str, ...]:
        return compiled_codecs(self.library)

    def keys(self):
        return self._keys.keys()

    def _rec(self, key: str) -> int:
        try:
            return self._keys[key]
        except KeyError:
            raise KeyError(f"record {key!r} not in packed index") from None

    def probe(self, key: str) -> Tuple[int, int]:
        """(height, width) from the image header, without a full decode."""
        rec = self._rec(key)
        if rec not in self._dims:
            h, w = ctypes.c_int(), ctypes.c_int()
            st = self._lib.mgld_probe(self._h, rec, ctypes.byref(h), ctypes.byref(w))
            if st != 0:
                raise IOError(f"probe({key}): {STATUS.get(st, st)}")
            self._dims[rec] = (h.value, w.value)
        return self._dims[rec]

    def decode(self, key: str) -> np.ndarray:
        """Full-frame float32 BGR [0, 1] decode of one record."""
        rec = self._rec(key)
        h, w = self.probe(key)
        out = np.empty((h, w, 3), np.float32)
        st = self._lib.mgld_decode_one(self._h, rec, _floats(out))
        if st != 0:
            raise IOError(f"decode({key}): {STATUS.get(st, st)}")
        return out

    def submit_clip(self, keys: Sequence[str], top: int, left: int, crop_h: int, crop_w: int,
                    hflip: bool = False, vflip: bool = False, transpose: bool = False) -> int:
        """Queue a decode and crop of a frame window; returns a ticket.
        Flips apply first, then the transpose (``augment``'s order)."""
        ids = np.asarray([self._rec(k) for k in keys], np.int32)
        oh, ow = (crop_w, crop_h) if transpose else (crop_h, crop_w)
        out = np.empty((len(keys), oh, ow, 3), np.float32)
        ticket = int(self._lib.mgld_submit(
            self._h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(keys), top, left,
            crop_h, crop_w, int(hflip), int(vflip), int(transpose), _floats(out)))
        self._pending[ticket] = out
        return ticket

    def fetch(self, ticket: int) -> np.ndarray:
        """Wait for ``ticket``; returns its [T, h, w, 3] clip."""
        out = self._pending.pop(ticket)
        st = self._lib.mgld_fetch(self._h, ticket)
        if st != 0:
            raise IOError(f"clip job: {STATUS.get(st, st)}")
        return out

    def load_clip(self, keys: Sequence[str], top: int, left: int, crop_h: int, crop_w: int,
                  **kw) -> np.ndarray:
        return self.fetch(self.submit_clip(keys, top, left, crop_h, crop_w, **kw))

    def close(self):
        if self._h:
            self._lib.mgld_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def pack_image_dir(root_dir: str, out_root: str,
                   exts: Tuple[str, ...] = (".png", ".jpg", ".jpeg")) -> int:
    """Pack an image tree into a packed record file whose keys are the paths
    relative to ``root_dir`` (a clip folder's frames are ``clip/name``);
    returns the record count."""
    from mgldvsr_tpu_torch.data.file_client import PackedMaker

    maker = PackedMaker(out_root)
    n = 0
    for dirpath, _dirs, files in sorted(os.walk(root_dir)):
        for name in sorted(files):
            if not name.lower().endswith(exts):
                continue
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                maker.put(os.path.relpath(path, root_dir), f.read())
            n += 1
    maker.close()
    return n

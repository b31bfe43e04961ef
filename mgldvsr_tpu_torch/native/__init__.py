"""The native (C++) host library of the training data path.

``src/clip_loader.cpp`` is a worker pool that reads packed records with
``pread``, decodes PNG and JPEG with libpng and libjpeg, and writes cropped,
flipped float32 frames into numpy buffers without holding the GIL
(:mod:`mgldvsr_tpu_torch.native.loader` binds it).

It is built with ``g++`` at first use into ``mgldvsr_tpu_torch/_build/``,
under a name keyed by a hash of the source and the flags. Each codec is
compiled in only where the compiler finds its header (``png.h``,
``jpeglib.h``); :func:`codecs` says which went in. The build writes a
per-process temporary file and renames it into place, so processes that
race here (prefetch workers, ranks) never load a partial file. Nothing is
built at import.
"""
from __future__ import annotations

import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src" / "clip_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# codec: (its header, the define that compiles it in, the libraries it links)
CODECS = {"png": ("png.h", "-DMGLD_HAVE_PNG", ("-lpng", "-lz")),
          "jpeg": ("jpeglib.h", "-DMGLD_HAVE_JPEG", ("-ljpeg",))}

_build_error: str | None = None


def _gxx() -> str:
    return os.environ.get("CXX", "g++")


@functools.cache
def found_codecs() -> tuple[str, ...]:
    """The codecs whose header the compiler finds on this machine (one
    preprocessor run each, all at once)."""
    procs = {}
    for name, (header, _, _) in CODECS.items():
        try:
            procs[name] = subprocess.Popen(
                [_gxx(), "-E", "-x", "c++", "-", "-o", os.devnull], stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, text=True)
        except OSError:  # no compiler
            return ()
        procs[name].stdin.write(f"#include <{header}>\n")
        procs[name].stdin.close()
    return tuple(name for name, proc in procs.items() if proc.wait() == 0)


def _command(codecs: tuple[str, ...], out: str) -> list[str]:
    cmd = [_gxx(), *FLAGS, *(CODECS[c][1] for c in codecs), str(SRC), "-o", out]
    for c in codecs:
        cmd += CODECS[c][2]
    return cmd + ["-lpthread"]


def library_path(codecs: tuple[str, ...] | None = None) -> Path:
    """Where the library with ``codecs`` (default: those found) is built."""
    codecs = found_codecs() if codecs is None else tuple(codecs)
    digest = hashlib.sha256(" ".join(_command(codecs, "")).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libmgld_native_{digest.hexdigest()[:16]}.so"


def build_native(force: bool = False, codecs: tuple[str, ...] | None = None) -> str:
    """Compile the library if its hashed file is missing; returns its path.
    ``codecs`` picks the codecs to compile in (default: every one whose
    header is found). Raises RuntimeError with the compiler's output on
    failure."""
    codecs = found_codecs() if codecs is None else tuple(codecs)
    unknown = set(codecs) - set(CODECS)
    if unknown:
        raise ValueError(f"unknown codecs {sorted(unknown)}; known: {sorted(CODECS)}")
    so = library_path(codecs)
    if so.is_file() and not force:
        return str(so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=so.stem + ".", suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = _command(codecs, tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    return str(so)


def native_available() -> bool:
    """True if the library is present or can be built here."""
    global _build_error
    if _build_error is not None:
        return False
    try:
        build_native()
        return True
    except Exception as e:  # no compiler
        _build_error = str(e)
        return False


def codecs() -> tuple[str, ...]:
    """The codecs compiled into the library (built if needed): a subset of
    ``("png", "jpeg")``."""
    from mgldvsr_tpu_torch.native.loader import compiled_codecs

    return compiled_codecs(build_native())

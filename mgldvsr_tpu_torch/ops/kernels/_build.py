"""Build and bind the port's CUDA C++ kernels.

All ``csrc/*.cu`` files are compiled by ``nvcc`` into one shared library
with a plain C interface for Hopper (``sm_90a``) and loaded with ``ctypes``.
The build happens at first use, into ``mgldvsr_tpu_torch/_build/`` under a
name keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as is. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types. Every function returns the
# cudaError_t of its launch (0 = success).
SIGNATURES = {
    # x, flow, out, n, h, w, c, stream
    "mgld_warp_fwd_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    # g, flow, dx, n, h, w, c, stream
    "mgld_warp_dx_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    # q, k, v, o, bh, n, d, scale, stream
    "mgld_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    "mgld_attention_bf16": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    # corr, coords, out, b, hw, hl, wl, level, n_levels, radius, stream
    "mgld_corr_lookup_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}


def _sources() -> list[Path]:
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA "
                       "toolkit's nvcc (set NVCC or install it under /usr/local/cuda)")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmgld_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if its hashed file is missing. Returns the path
    and the seconds spent compiling (0.0 when it was already built)."""
    so = library_path()
    if so.is_file():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    return so, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream

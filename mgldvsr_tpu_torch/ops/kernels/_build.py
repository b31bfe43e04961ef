"""Build and bind the port's CUDA C++ kernels.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for Hopper (``sm_90a``),
one compiler process per source and all at once, then linked into one
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use, into ``mgldvsr_tpu_torch/_build/`` under a
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
              "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_longlong
_LP = ctypes.POINTER(ctypes.c_longlong)
_IP = ctypes.POINTER(ctypes.c_int)
# C entry points: name -> argument types. Every function returns the
# cudaError_t of its launch (0 = success).
SIGNATURES = {
    # x, flow, out, n, h, w, c, stream
    "mgld_warp_fwd_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    # g, flow, dx, n, h, w, c, stream
    "mgld_warp_dx_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    # latents, flow_fwd, flow_bwd, occ_fwd, occ_bwd, grad, cotangent scratch,
    # term table (host ints), latents' and grad's strides[4], b, t, h, w, c, slots, 1/N, stream
    "mgld_guidance_residual_f32": (_P, _P, _P, _P, _P, _P, _P, _IP, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _F, _P),
    # flow_fwd, flow_bwd, cotangent scratch, grad, int64 accumulator, term table, grad's
    # strides[4], b, t, h, w, c, slots, fixed-point scale, stream
    "mgld_guidance_scatter_f32": (_P, _P, _P, _P, _P, _IP, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _D, _P),
    # q, k, v, o, bh, n, d, scale, stream
    "mgld_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    "mgld_attention_bf16": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    # q, k, v, o, batch, heads, n, strides[12], scale, stream
    "mgld_attention_wgmma_bf16": (_P, _P, _P, _P, _I, _I, _I, _LP, _F, _P),
    # q, k, v, o, batch, n, tok_major, strides[8], scale, stream
    "mgld_attention_wide_bf16": (_P, _P, _P, _P, _I, _I, _I, _LP, _F, _P),
    # q, k, v, o, batch, n, strides[8], scale, stream
    "mgld_attention_wide_f32": (_P, _P, _P, _P, _I, _I, _LP, _F, _P),
    # levels[n_levels][3] (address, hl, wl), coords, out, b, hw, n_levels, radius, stream
    "mgld_corr_lookup_f32": (_LP, _P, _P, _I, _I, _I, _I, _P),
    # x, scale, shift, weight, bias, out, n, c, h, w, co, stream
    "mgld_gn_silu_conv_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "mgld_gn_silu_conv_f16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "mgld_gn_silu_conv_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, scale, shift, weight re-laid [9][co][cp], bias, out, n, c, cp, h, w, co, stream
    "mgld_gn_silu_conv_wgmma_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # the chain from one call: x, GroupNorm weight, GroupNorm bias, fp32 scratch [2, n, c]
    # (scale, shift), conv weight (re-laid [9][co][cp] for wgmma), bias, out, n, c, (cp,) h, w,
    # co, groups, eps, stream
    "mgld_gn_silu_conv_chain_wgmma_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                           _I, _F, _P),
    "mgld_gn_silu_conv_chain_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "mgld_gn_silu_conv_chain_f16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "mgld_gn_silu_conv_chain_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # x, GroupNorm weight, GroupNorm bias, scale, shift, n, c, h*w, groups, eps, stream
    "mgld_gn_scale_shift_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "mgld_gn_scale_shift_f16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "mgld_gn_scale_shift_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # x, sums fp32 [rows], sums of squares fp32 [rows], rows, elements a row, threads a
    # block (one block a row), stream
    "mgld_channel_sums_bf16": (_P, _P, _P, _L, _L, _I, _P),
    "mgld_channel_sums_f16": (_P, _P, _P, _L, _L, _I, _P),
    "mgld_channel_sums_f32": (_P, _P, _P, _L, _L, _I, _P),
    # x, x's type (0 f32, 1 bf16, 2 f16), element count, 4-byte scratch for max|x|, stream
    "mgld_int8_absmax": (_P, _I, _L, _P, _P),
    # x, x's type, max|x| scratch (filled by the chain), levels re-laid [9][co][cp], scales
    # fp32 [co], bias fp32 [co], out, out's type, n, c, cp, h, w, co, stride, stream
    "mgld_int8_conv3x3": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "mgld_int8_conv3x3_chain": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, GroupNorm weight, GroupNorm bias, y, samples * groups, channels a group, spatial
    # elements a channel, groups, eps, blocks a slab, shared-memory bytes of a share, stream
    "mgld_group_norm_bf16": (_P, _P, _P, _P, _L, _I, _L, _I, _F, _I, _I, _P),
    "mgld_group_norm_f16": (_P, _P, _P, _P, _L, _I, _L, _I, _F, _I, _I, _P),
    "mgld_group_norm_f32": (_P, _P, _P, _P, _L, _I, _L, _I, _F, _I, _I, _P),
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
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", str(src),
                   "-o", str(Path(work) / (src.stem + ".o"))]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)))
        results = [(cmd, proc, *proc.communicate()) for cmd, proc in jobs]
        for cmd, proc, out, err in results:
            _raise_on_failure(cmd, proc.returncode, out, err)
        tmp = str(Path(work) / "lib.so")
        cmd = [nvcc, "-shared", "-o", tmp, *(job[0][-1] for job in jobs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        _raise_on_failure(cmd, link.returncode, link.stdout, link.stderr)
        os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    return so, time.perf_counter() - t0


def _raise_on_failure(cmd, returncode: int, out: str, err: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{out}\n{err}")


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


@functools.cache
def bind(name: str):
    """``(C entry, stream getter)`` for a wrapper's launch path, looked up
    once: the ctypes function ``name`` of the loaded library (built on first
    call), and ``torch._C._cuda_getCurrentRawStream``, which gives the
    current stream of a device index as the integer the entries take."""
    import torch

    return getattr(library(), name), torch._C._cuda_getCurrentRawStream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as the integer the C entries take."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    # the same handle without building a Stream object: a tenth of the host time
    return raw(torch.cuda.current_device() if device.index is None else device.index)

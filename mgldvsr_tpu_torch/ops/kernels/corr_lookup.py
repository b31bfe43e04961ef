"""RAFT correlation-window lookup: CUDA kernel and its plain version.

Replaces ``mgldvsr_tpu/ops/pallas/corr_lookup.py``: the kernel
``_pallas_window_patches`` and the blend and transposed flatten that
``lookup_corr_pallas`` wraps around it. It is bound by device-memory
traffic (the [B,H,W,324] output and scattered window reads); the TPU
kernel padded every level and selected patches with one-hot matmuls,
while the CUDA kernel (``csrc/corr_lookup.cu``) reads the windows straight
from the unpadded level maps, so no padded pyramid is built. All levels go
in one launch: a warp per (query, level) stages that level's (2r+2)^2
integer window in shared memory, every cell read once, blends its (2r+1)^2
samples from it and writes them as one contiguous run; the runs of a query,
and of a block, lie one behind the other.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(once per call) or raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from mgldvsr_tpu_torch.ops.kernels import _build


MAX_LEVELS = 8            # the kernel takes the levels' addresses and sizes by value
MAX_WINDOW_CELLS = 1536   # (2r+2)^2: the eight windows of a block in 48 KB of shared memory


def lookup_corr_plain(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                      radius: int = 4) -> torch.Tensor:
    """Plain version: the JAX ``flow/raft.lookup_corr`` block gather.

    pyramid: per level [B, H*W, Hl, Wl]; coords [B,H,W,2] level-0 (x, y).
    Returns [B, H, W, levels*(2r+1)^2] in the reference's transposed window
    order, zeros outside each map."""
    b, h, w, _ = coords.shape
    n = h * w
    r = radius
    win = 2 * r + 1
    pad = 2 * r + 3
    side = torch.arange(2 * r + 2, device=coords.device)
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[2], corr.shape[3]
        cp = F.pad(corr, (pad, pad, pad, pad))
        ctr = coords.reshape(b, n, 2) / (2 ** lvl)
        x0 = torch.floor(ctr[..., 0])
        y0 = torch.floor(ctr[..., 1])
        tx = (ctr[..., 0] - x0)[..., None, None].to(corr.dtype)
        ty = (ctr[..., 1] - y0)[..., None, None].to(corr.dtype)
        sx = x0.clamp(-r - 2, wl + r + 1).to(torch.int64) - r + pad
        sy = y0.clamp(-r - 2, hl + r + 1).to(torch.int64) - r + pad
        rows = (sy[..., None] + side)[..., :, None]          # [B,N,S,1]
        cols = (sx[..., None] + side)[..., None, :]          # [B,N,1,S]
        bi = torch.arange(b, device=coords.device)[:, None, None, None]
        qi = torch.arange(n, device=coords.device)[None, :, None, None]
        patch = cp[bi, qi, rows, cols]                       # [B,N,S,S]
        pa, pb = patch[..., :win, :win], patch[..., :win, 1:]
        pc, pd = patch[..., 1:, :win], patch[..., 1:, 1:]
        sampled = ((1 - ty) * (1 - tx) * pa + (1 - ty) * tx * pb
                   + ty * (1 - tx) * pc + ty * tx * pd)
        out.append(sampled.transpose(-1, -2).reshape(b, n, win * win))
    return torch.cat(out, dim=-1).reshape(b, h, w, -1)


def lookup_corr(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Window lookup with the same contract as :func:`lookup_corr_plain`."""
    if coords.device.type == "cpu":
        return lookup_corr_plain(pyramid, coords, radius)
    b, h, w, two = coords.shape
    if two != 2 or coords.dtype != torch.float32 or not coords.is_contiguous():
        raise ValueError(f"lookup_corr: coords must be contiguous float32 [B,H,W,2], "
                         f"got {tuple(coords.shape)} {coords.dtype}")
    n_levels = len(pyramid)
    side = 2 * radius + 2
    if not 1 <= n_levels <= MAX_LEVELS or radius < 0 or side * side > MAX_WINDOW_CELLS:
        raise ValueError(f"lookup_corr: 1 to {MAX_LEVELS} levels, windows of up to "
                         f"{MAX_WINDOW_CELLS} cells, got {n_levels} levels, radius {radius}")
    levels = []
    for corr in pyramid:
        if (corr.dtype != torch.float32 or corr.ndim != 4 or corr.shape[:2] != (b, h * w)
                or not corr.is_contiguous() or corr.device != coords.device):
            raise ValueError(f"lookup_corr: each level must be contiguous float32 "
                             f"[{b},{h * w},Hl,Wl] on {coords.device}, got "
                             f"{tuple(corr.shape)} {corr.dtype} {corr.device}")
        levels += (corr.data_ptr(), corr.shape[2], corr.shape[3])
    out = torch.empty(b, h, w, n_levels * (2 * radius + 1) ** 2, dtype=torch.float32,
                      device=coords.device)
    err = _build.library().mgld_corr_lookup_f32(
        (ctypes.c_longlong * len(levels))(*levels), coords.data_ptr(), out.data_ptr(), b, h * w,
        n_levels, radius, _build.stream_ptr(coords.device))
    _build.check(err, "mgld_corr_lookup_f32")
    lookup_corr.launches += 1
    return out


lookup_corr.launches = 0

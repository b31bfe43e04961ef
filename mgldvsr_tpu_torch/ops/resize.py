"""Image resizing as dense matrix products.

Counterpart of ``mgldvsr_tpu/ops/resize.py``: each 1-D resample is a small
[out, in] matrix built once in numpy, and a 2-D resize is two contractions.
Bicubic uses the Keys kernel with a=-0.75 and replicated borders. This is
deliberately not ``F.interpolate``, whose border taps differ.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2.0, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, method: str, align_corners: bool,
                   antialias: bool) -> np.ndarray:
    """Dense [out_size, in_size] float32 resampling matrix, rows summing to 1."""
    if method == "nearest":
        idx = np.floor(np.arange(out_size) * in_size / out_size).astype(np.int64)
        m = np.zeros((out_size, in_size), dtype=np.float64)
        m[np.arange(out_size), np.clip(idx, 0, in_size - 1)] = 1.0
        return m.astype(np.float32)
    if method == "area":
        m = np.zeros((out_size, in_size), dtype=np.float64)
        for i in range(out_size):
            j0 = (i * in_size) // out_size
            j1 = -((-(i + 1) * in_size) // out_size)
            m[i, j0:j1] = 1.0
        m /= m.sum(axis=1, keepdims=True)
        return m.astype(np.float32)

    kernel = {"bicubic": _cubic_kernel, "bilinear": _linear_kernel}[method]
    support = {"bicubic": 2.0, "bilinear": 1.0}[method]
    if align_corners and out_size > 1:
        scale = (in_size - 1) / (out_size - 1)
        centers = np.arange(out_size) * scale
    else:
        scale = in_size / out_size
        centers = (np.arange(out_size) + 0.5) * scale - 0.5
    filt_scale = max(scale, 1.0) if (antialias and not align_corners) else 1.0
    eff_support = support * filt_scale
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for i, c in enumerate(centers):
        j0 = int(np.floor(c - eff_support)) + 1
        j1 = int(np.floor(c + eff_support)) + 1
        js = np.arange(j0, j1)
        w = kernel((js - c) / filt_scale)
        for j, wj in zip(np.clip(js, 0, in_size - 1), w):
            m[i, j] += wj
    s = m.sum(axis=1, keepdims=True)
    s[s == 0] = 1.0
    return (m / s).astype(np.float32)


def resize2d(x: torch.Tensor, size: tuple[int, int], method: str = "bicubic",
             align_corners: bool = False, antialias: bool = False) -> torch.Tensor:
    """Resize [..., H, W, C] images (leading axes are batch) to ``size``,
    computing in float32 and returning ``x``'s dtype."""
    out_h, out_w = size
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    xf = x.to(torch.float32)
    if h != out_h:
        mh = torch.from_numpy(_resize_matrix(h, out_h, method, align_corners,
                                             antialias)).to(x.device)
        xf = torch.einsum("oh,...hwc->...owc", mh, xf)
    if w != out_w:
        mw = torch.from_numpy(_resize_matrix(w, out_w, method, align_corners,
                                             antialias)).to(x.device)
        xf = torch.einsum("ow,...hwc->...hoc", mw, xf)
    return xf.to(x.dtype)

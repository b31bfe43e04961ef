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


def _resample(x: torch.Tensor, size: tuple[int, int], matrix) -> torch.Tensor:
    """[..., H, W, C] images to ``size`` by two contractions with the
    [out, in] matrices ``matrix(in, out)``, in float32; ``x``'s dtype back."""
    out_h, out_w = size
    h, w = x.shape[-3], x.shape[-2]
    xf = x.to(torch.float32)
    if h != out_h:
        xf = torch.einsum("oh,...hwc->...owc", torch.from_numpy(matrix(h, out_h)).to(x.device), xf)
    if w != out_w:
        xf = torch.einsum("ow,...hwc->...hoc", torch.from_numpy(matrix(w, out_w)).to(x.device), xf)
    return xf.to(x.dtype)


def resize2d(x: torch.Tensor, size: tuple[int, int], method: str = "bicubic",
             align_corners: bool = False, antialias: bool = False) -> torch.Tensor:
    """Resize [..., H, W, C] images (leading axes are batch) to ``size``,
    computing in float32 and returning ``x``'s dtype."""
    if tuple(x.shape[-3:-1]) == tuple(size):
        return x
    return _resample(x, size, lambda i, o: _resize_matrix(i, o, method, align_corners,
                                                          antialias))


def _keys_cubic_half(x: np.ndarray) -> np.ndarray:
    """The Keys cubic with a = -0.5 on |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=64)
def _scale_matrix(in_size: int, out_size: int, method: str, antialias: bool) -> np.ndarray:
    """[out_size, in_size] float32: ``jax.image.resize``'s weights (the
    triangle or the a = -0.5 Keys cubic, widened by the scale when
    shrinking with ``antialias``, each row's in-range taps renormalised)."""
    kernel = {"bilinear": lambda x: np.maximum(0.0, 1.0 - x), "bicubic": _keys_cubic_half}[method]
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    w = kernel(np.abs(sample[:, None] - np.arange(in_size)[None, :]) / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def image_resize(x: torch.Tensor, size: tuple[int, int], method: str = "bilinear",
                 antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize`` of [..., H, W, C] images to ``size`` with
    ``method`` "bilinear" or "bicubic" (what the JAX package's encoders
    call; the CLIP image preprocessing passes ``antialias=False``). Computes
    in float32 and returns ``x``'s dtype."""
    return _resample(x, size, lambda i, o: _scale_matrix(i, o, method, antialias))

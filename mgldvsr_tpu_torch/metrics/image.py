"""Image quality metrics: PSNR and SSIM with MATLAB parity on the host, and
batched tensor versions.

Counterpart of ``mgldvsr_tpu/metrics/image.py`` (basicsr's
``calculate_psnr`` / ``calculate_ssim``): [0, 255] HWC numpy images with
``crop_border`` and an optional BT.601 Y channel, SSIM with an 11x11
Gaussian window (sigma 1.5) and the valid crop. SSIM's filter is
:func:`mgldvsr_tpu_torch.data.cv_ops.filter2D` (OpenCV's default
``BORDER_REFLECT_101``), so no OpenCV is needed. ``psnr_tensor`` and
``ssim_tensor`` take [0, 1] NHWC tensors on any device and return one value
an image.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mgldvsr_tpu_torch.data.cv_ops import filter2D


def rgb_to_y(img_255: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 Y channel of an RGB [0,255] image (+16 offset), as
    basicsr's ``to_y_channel``: [H, W, 1] float64."""
    img = img_255.astype(np.float64) / 255.0
    y = img[..., 0] * 65.481 + img[..., 1] * 128.553 + img[..., 2] * 24.966 + 16.0
    return y[..., None]


def _crop_and_y(img, img2, crop_border: int, test_y_channel: bool):
    if img.shape != img2.shape:
        raise ValueError(f"image shapes differ: {img.shape} and {img2.shape}")
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel:
        img, img2 = rgb_to_y(img), rgb_to_y(img2)
    return img, img2


def calculate_psnr(img: np.ndarray, img2: np.ndarray, crop_border: int = 0,
                   test_y_channel: bool = False) -> float:
    """PSNR in dB of two [0,255] HWC images; inf when they are equal."""
    img, img2 = _crop_and_y(img, img2, crop_border, test_y_channel)
    mse = np.mean((img.astype(np.float64) - img2.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 ** 2 / mse)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g)


def _ssim_channel(img: np.ndarray, img2: np.ndarray) -> float:
    """SSIM of one [0,255] channel: 11x11 Gaussian window, valid crop (the
    MATLAB protocol)."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img = img.astype(np.float64)
    img2 = img2.astype(np.float64)
    win = _gaussian_window()

    def f(x):
        return filter2D(x, -1, win)[5:-5, 5:-5]

    mu1 = f(img)
    mu2 = f(img2)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = f(img ** 2) - mu1_sq
    s2 = f(img2 ** 2) - mu2_sq
    s12 = f(img * img2) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(ssim_map.mean())


def calculate_ssim(img: np.ndarray, img2: np.ndarray, crop_border: int = 0,
                   test_y_channel: bool = False) -> float:
    """Mean over channels of the SSIM of two [0,255] HWC images."""
    img, img2 = _crop_and_y(img, img2, crop_border, test_y_channel)
    return float(np.mean([_ssim_channel(img[..., c], img2[..., c])
                          for c in range(img.shape[-1])]))


def psnr_tensor(a: torch.Tensor, b: torch.Tensor, crop_border: int = 0) -> torch.Tensor:
    """[N] PSNR in dB of [0,1] NHWC batches (the MSE floored at 1e-12)."""
    if crop_border:
        a = a[:, crop_border:-crop_border, crop_border:-crop_border]
        b = b[:, crop_border:-crop_border, crop_border:-crop_border]
    mse = torch.mean((a - b) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))


def ssim_tensor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N] SSIM of [0,1] NHWC batches: the window as a depthwise valid
    convolution, the map averaged over pixels and channels."""
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    c = a.shape[-1]
    win = torch.as_tensor(_gaussian_window(), dtype=torch.float32, device=a.device)
    kernel = win[None, None].expand(c, 1, *win.shape).contiguous()

    def f(x):
        return F.conv2d(x.permute(0, 3, 1, 2), kernel, groups=c)

    mu1, mu2 = f(a), f(b)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = f(a * a) - mu1_sq
    s2 = f(b * b) - mu2_sq
    s12 = f(a * b) - mu12
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(m, dim=(1, 2, 3))

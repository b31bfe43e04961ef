"""On-device image processing for the synthesis degradation path.

Counterpart of ``mgldvsr_tpu/ops/img_process.py``: batched ``filter2d``
with one kernel or a kernel a sample (reflect padding, cv2's
``BORDER_REFLECT_101``), USM sharpening, and Gaussian and Poisson-like
noise. Images are NHWC at every function's boundary, as in JAX, and NCHW
inside the convolutions. A kernel a sample is one grouped convolution
(``groups = N·C``); the JAX package computes it with ``lax.conv`` outside
any Pallas kernel, so a library convolution is its counterpart here.

Each noise is a draw (``draw_*_noise``: the amount, the gray flag and the
normal field, from a ``torch.Generator``) and an apply (``add_*_noise``)
that takes those draws, so that a test can hand the apply the JAX package's
own draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


def filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """img [N,H,W,C]; kernel [k,k], [1,k,k] or [N,k,k] (a kernel a
    sample), k odd. Reflect padding; the result in ``img``'s dtype."""
    n, h, w, c = img.shape
    if kernel.ndim == 2:
        kernel = kernel[None]
    k = kernel.shape[-1]
    if k % 2 != 1:
        raise ValueError(f"filter2d: kernel size {k} must be odd")
    pad = k // 2
    x = F.pad(img.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    kern = kernel.to(device=img.device, dtype=img.dtype)
    if kern.shape[0] == 1:
        out = F.conv2d(x, kern.expand(c, k, k)[:, None], groups=c)
    else:
        out = F.conv2d(x.reshape(1, n * c, h + 2 * pad, w + 2 * pad),
                       kern.repeat_interleave(c, dim=0)[:, None], groups=n * c)
        out = out.reshape(n, c, h, w)
    return out.permute(0, 2, 3, 1)


def _gaussian_kernel1d(size: int, sigma: float, device) -> torch.Tensor:
    ax = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(ax ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def usm_sharp(img: torch.Tensor, weight: float = 0.5, radius: int = 50,
              threshold: float = 10.0) -> torch.Tensor:
    """USM sharpening of [N,H,W,C] images in [0, 1]: the residual against a
    Gaussian blur (a ``radius`` x ``radius`` kernel, odd), a hard mask where
    |residual|·255 > ``threshold``, the mask softened by the same blur."""
    if radius % 2 == 0:
        radius += 1
    sigma = 0.3 * ((radius - 1) * 0.5 - 1) + 0.8  # cv2's default sigma rule
    g1 = _gaussian_kernel1d(radius, sigma, img.device)
    kern = torch.outer(g1, g1)
    residual = img - filter2d(img, kern)
    mask = (residual.abs() * 255.0 > threshold).to(img.dtype)
    soft_mask = filter2d(mask, kern)
    sharp = torch.clamp(img + weight * residual, 0.0, 1.0)
    return soft_mask * sharp + (1.0 - soft_mask) * img


class NoiseDraw(NamedTuple):
    """A noise's draws for N images: ``amount`` [N] (the Gaussian's sigma
    over 255, or the Poisson-like noise's scale), ``gray`` [N] (1.0 where
    the noise is shared by the channels) and ``field`` [N,H,W,C] ~ N(0, 1)."""
    amount: torch.Tensor
    gray: torch.Tensor
    field: torch.Tensor


def draw_uniform(n: int, lo: float, hi: float, generator, device) -> torch.Tensor:
    """[n] uniform in [lo, hi) from ``generator``."""
    return torch.rand(n, generator=generator, device=device) * (hi - lo) + lo


def draw_noise(generator: Optional[torch.Generator], shape, amount_range: Tuple[float, float],
               gray_prob: float, device, gaussian: bool = True) -> NoiseDraw:
    """The draws of :func:`add_gaussian_noise` (``gaussian``: the sigma is
    drawn in ``amount_range`` / 255) or of :func:`add_poisson_noise` (the
    scale in ``amount_range``) for images of ``shape`` [N,H,W,C]."""
    n = shape[0]
    amount = draw_uniform(n, *amount_range, generator, device)
    if gaussian:
        amount = amount / 255.0
    gray = (torch.rand(n, generator=generator, device=device) < gray_prob).float()
    field = torch.randn(tuple(shape), generator=generator, device=device)
    return NoiseDraw(amount, gray, field)


def _per_image(v: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    return v.to(device=img.device, dtype=img.dtype).reshape(-1, 1, 1, 1)


def add_gaussian_noise(img: torch.Tensor, draw: NoiseDraw, clip: bool = True) -> torch.Tensor:
    """``img`` + sigma · noise, each image's noise the field or, where it
    is gray, the field's mean over the channels."""
    gray = _per_image(draw.gray, img)
    field = draw.field.to(img.device, img.dtype)
    noise = gray * field.mean(dim=-1, keepdim=True) + (1 - gray) * field
    out = img + noise * _per_image(draw.amount, img)
    return torch.clamp(out, 0, 1) if clip else out


def add_poisson_noise(img: torch.Tensor, draw: NoiseDraw, clip: bool = True) -> torch.Tensor:
    """Shot noise as a Gaussian of variance img / 2^10 (the JAX package's
    differentiable approximation), times each image's scale; gray images
    take the channels' mean field with the luminance's deviation."""
    vals = 2.0 ** 10
    gray = _per_image(draw.gray, img)
    base = torch.clamp(img, 0, 1)
    std_c = torch.sqrt(base / vals)
    std_g = torch.sqrt(base.mean(dim=-1, keepdim=True) / vals)
    g = draw.field.to(img.device, img.dtype)
    noise = gray * g.mean(dim=-1, keepdim=True) * std_g + (1 - gray) * g * std_c
    out = img + noise * _per_image(draw.amount, img)
    return torch.clamp(out, 0, 1) if clip else out

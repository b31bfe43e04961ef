"""Colour fix: move the LQ input's colour statistics onto the SR output.

Counterpart of ``mgldvsr_tpu/infer/colorfix.py`` (NHWC): ``adain`` is
per-channel moment transfer; ``wavelet`` keeps the output's high
frequencies and the input's low ones, split by five dilated 3x3 blurs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mgldvsr_tpu_torch.core.diffusion import adaptive_instance_normalization

_WAVELET_KERNEL = ((0.0625, 0.125, 0.0625), (0.125, 0.25, 0.125), (0.0625, 0.125, 0.0625))


def adain_color_fix(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    return adaptive_instance_normalization(target, source)


def wavelet_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    """Depthwise 3x3 blur, dilation ``radius``, replicate padding."""
    c = image.shape[-1]
    x = image.permute(0, 3, 1, 2).float()
    x = F.pad(x, (radius,) * 4, mode="replicate")
    k = torch.tensor(_WAVELET_KERNEL, dtype=torch.float32, device=image.device)
    out = F.conv2d(x, k[None, None].repeat(c, 1, 1, 1), dilation=radius, groups=c)
    return out.permute(0, 2, 3, 1).to(image.dtype)


def wavelet_decomposition(image: torch.Tensor, levels: int = 5):
    high = torch.zeros_like(image)
    low = image
    for i in range(levels):
        blurred = wavelet_blur(low, 2 ** i)
        high = high + (low - blurred)
        low = blurred
    return high, low


def wavelet_color_fix(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    return wavelet_decomposition(target)[0] + wavelet_decomposition(source)[1]


def apply_colorfix(output: torch.Tensor, reference_lq: torch.Tensor,
                   kind: str | None = "adain") -> torch.Tensor:
    if kind == "adain":
        return adain_color_fix(output, reference_lq)
    if kind == "wavelet":
        return wavelet_color_fix(output, reference_lq)
    if kind in ("none", "nofix", None):
        return output
    raise ValueError(f"unknown colorfix type {kind!r}")

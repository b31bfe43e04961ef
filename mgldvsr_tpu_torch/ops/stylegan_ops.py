"""StyleGAN2's resampling and activation ops in plain PyTorch.

Counterpart of ``mgldvsr_tpu/ops/stylegan_ops.py`` (basicsr's
``fused_act`` and ``upfirdn2d`` CUDA extensions, which the JAX package
rebuilt as plain XLA): the fused bias + LeakyReLU + sqrt(2) gain, and
upsample (zero-stuffing) / pad / FIR (a depthwise convolution with the
flipped kernel) / downsample (striding). The public functions take NHWC
images as the JAX ones do; ``upfirdn2d_nchw`` is the same op on NCHW, which
the StyleGAN2 modules use inside.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2, scale: float = 2 ** 0.5) -> torch.Tensor:
    """leaky_relu(x + bias) * scale; ``bias`` broadcasts on the last axis
    (pass it shaped for the channel axis of NCHW tensors)."""
    if bias is not None:
        x = x + bias
    return F.leaky_relu(x, negative_slope) * scale


def make_resample_kernel(k: Sequence[float]) -> np.ndarray:
    """1-D taps -> the normalised 2-D separable FIR kernel."""
    k1 = np.asarray(k, dtype=np.float32)
    kern = np.outer(k1, k1)
    return kern / kern.sum()


def upfirdn2d_nchw(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
                   pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """:func:`upfirdn2d` on [N,C,H,W]."""
    n, c, h, w = x.shape
    kh, kw = kernel.shape
    if up > 1:
        z = x.new_zeros((n, c, h, up, w, up))
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(n, c, h * up, w * up)
    p0, p1 = pad
    x = F.pad(x, (max(p0, 0), max(p1, 0), max(p0, 0), max(p1, 0)))
    if p0 < 0 or p1 < 0:
        x = x[:, :, max(-p0, 0): x.shape[2] - max(-p1, 0), max(-p0, 0): x.shape[3] - max(-p1, 0)]
    kern = torch.flip(kernel, (0, 1)).to(x.dtype).expand(c, 1, kh, kw)
    out = F.conv2d(x, kern, groups=c)
    if down > 1:
        out = out[:, :, ::down, ::down]
    return out


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """x [N,H,W,C]: upsample by zero-stuffing, pad (negative pads crop),
    FIR-filter each channel, downsample by striding."""
    return upfirdn2d_nchw(x.permute(0, 3, 1, 2), kernel, up, down, pad).permute(0, 2, 3, 1)


def upsample2x(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """StyleGAN2's Upsample: the factor-normalised FIR after zero-stuffing."""
    kh = kernel.shape[0]
    return upfirdn2d(x, kernel * 4.0, up=2, down=1, pad=((kh + 1) // 2, (kh - 1) // 2))


def downsample2x(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    kh = kernel.shape[0]
    return upfirdn2d(x, kernel, up=1, down=2, pad=((kh - 1) // 2, (kh - 2) // 2))

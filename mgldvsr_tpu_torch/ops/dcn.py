"""Modulated deformable convolution (DCNv2) in plain PyTorch.

Counterpart of ``mgldvsr_tpu/ops/dcn.py``: K bilinear gathers of the input
at the offset taps (zeros outside the image), giving a [N, H, W, K, Cin]
sampled tensor, then one [K*Cin, Cout] contraction. Used by EDVR's PCD
alignment, BasicVSR++'s flow-guided alignment and MaskFlownet's deformable
blend. Stride 1, odd kernels, any padding, dilation and deform groups.
Differentiable by autograd; runs on its tensors' device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _bilinear_taps(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """x [N,H,W,G,Cg]; py/px [N,H,W,K,G] absolute sample coordinates ->
    [N,H,W,K,G,Cg], zeros outside the image (the JAX blend, corner by
    corner)."""
    n, h, w, g, cg = x.shape
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    tx = (px - x0).to(x.dtype)[..., None]
    ty = (py - y0).to(x.dtype)[..., None]
    # clamp before the cast: a clamped base's taps all lie outside and read 0
    x0i = x0.clamp(-2, w + 1).to(torch.int64)
    y0i = y0.clamp(-2, h + 1).to(torch.int64)
    rows = x.reshape(n * h * w * g, cg)
    batch = torch.arange(n, device=x.device).view(n, 1, 1, 1, 1) * (h * w)
    group = torch.arange(g, device=x.device).view(1, 1, 1, 1, g)

    def corner(dy: int, dx: int) -> torch.Tensor:
        ix = x0i + dx
        iy = y0i + dy
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        pix = batch + iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
        v = rows.index_select(0, (pix * g + group).reshape(-1)).view(*pix.shape, cg)
        return v * inb[..., None].to(x.dtype)

    top = corner(0, 0) * (1 - tx) + corner(0, 1) * tx
    bot = corner(1, 0) * (1 - tx) + corner(1, 1) * tx
    return top * (1 - ty) + bot * ty


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: Optional[torch.Tensor],
                            weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                            kernel_size: Tuple[int, int] = (3, 3), padding: int = 1,
                            dilation: int = 1, deform_groups: int = 1) -> torch.Tensor:
    """x [N,H,W,Cin]; offset [N,H,W,2*G*K] laid out [g, k, (y, x)]; mask
    [N,H,W,G*K] (already through a sigmoid) or None; weight [Cout, Cin, kh,
    kw] (torch layout). Returns [N,H,W,Cout]."""
    n, h, w, cin = x.shape
    kh, kw = kernel_size
    k = kh * kw
    g = deform_groups
    off = offset.reshape(n, h, w, g, k, 2).transpose(3, 4)  # [N,H,W,K,G,2]
    ky = torch.tensor([(i // kw) * dilation - padding for i in range(k)], dtype=x.dtype,
                      device=x.device).view(1, 1, 1, k, 1)
    kx = torch.tensor([(i % kw) * dilation - padding for i in range(k)], dtype=x.dtype,
                      device=x.device).view(1, 1, 1, k, 1)
    gy = torch.arange(h, dtype=x.dtype, device=x.device).view(1, h, 1, 1, 1)
    gx = torch.arange(w, dtype=x.dtype, device=x.device).view(1, 1, w, 1, 1)
    py = (gy + ky) + off[..., 0]
    px = (gx + kx) + off[..., 1]
    sampled = _bilinear_taps(x.reshape(n, h, w, g, cin // g), py, px)  # [N,H,W,K,G,Cg]
    if mask is not None:
        sampled = sampled * mask.reshape(n, h, w, g, k).transpose(3, 4)[..., None]
    wk = weight.permute(2, 3, 1, 0).reshape(k * cin, -1)  # [(K, Cin), Cout]
    out = sampled.reshape(n * h * w, k * cin) @ wk.to(x.dtype)
    out = out.reshape(n, h, w, -1)
    if bias is not None:
        out = out + bias
    return out


class DCNv2Pack(nn.Module):
    """A conv over ``feat`` predicts offsets and masks that deform-sample
    ``x`` (basicsr's DCNv2Pack). The offset conv's first two chunks
    interleave into the [g, k, (y, x)] layout. Keys: ``weight``, ``bias``,
    ``conv_offset.{weight,bias}``; NHWC in and out."""

    def __init__(self, in_channels: int, out_channels: int, deform_groups: int = 8,
                 kernel_size: int = 3, padding: int = 1):
        super().__init__()
        k = kernel_size * kernel_size
        self.deform_groups, self.kernel_size, self.padding = deform_groups, kernel_size, padding
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.conv_offset = nn.Conv2d(in_channels, 3 * deform_groups * k, kernel_size,
                                     padding=padding)

    def forward(self, x: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        out = F.conv2d(feat.permute(0, 3, 1, 2), self.conv_offset.weight, self.conv_offset.bias,
                       padding=self.padding).permute(0, 2, 3, 1)
        o1, o2, m = torch.chunk(out, 3, dim=-1)
        offset = torch.stack([o1, o2], dim=-1).flatten(-2)
        ks = (self.kernel_size, self.kernel_size)
        return modulated_deform_conv2d(x, offset, torch.sigmoid(m), self.weight, self.bias, ks,
                                       self.padding, deform_groups=self.deform_groups)

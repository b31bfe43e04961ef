"""Temporal mixing: the 3x1x1 temporal conv and temporal self-attention.

Counterpart of ``mgldvsr_tpu/models/temporal.py``. Inputs are the flattened
video layout [B*T, C, H, W]. Both modules blend with a learnable scalar:
out = alpha * temporal(x) + (1 - alpha) * x (key ``temporal_alpha``);
``MultiDimTemporalConv`` gates by sigmoid(alpha) instead.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from mgldvsr_tpu_torch.models.layers import Conv3d, LayerNorm, Linear
from mgldvsr_tpu_torch.ops.attention import attention_math


class SpatialTemporalConv(nn.Module):
    """Per-pixel conv of kernel 3 over T (key ``temporal_conv``)."""

    def __init__(self, channels: int, num_frames: int):
        super().__init__()
        self.num_frames = num_frames
        self.temporal_conv = Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))
        self.temporal_alpha = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        bt, c, h, w = x.shape
        t = self.num_frames
        v = x.reshape(bt // t, t, c, h, w).permute(0, 2, 1, 3, 4)
        res = self.temporal_conv(v).permute(0, 2, 1, 3, 4).reshape(bt, c, h, w)
        alpha = self.temporal_alpha.to(x.dtype)
        return alpha * res.to(x.dtype) + (1 - alpha) * x


class MultiDimTemporalConv(nn.Module):
    """Two temporal convs over T, kernel 3 at dilation 1 and 2 (keys
    ``temporal_conv1``, ``temporal_conv2``), blended by a sigmoid gate:
    out = g * (conv1(x) + conv2(x)) + (1 - g) * x, g = sigmoid(alpha)
    (key ``temporal_alpha``)."""

    def __init__(self, channels: int, num_frames: int):
        super().__init__()
        self.num_frames = num_frames
        self.temporal_conv1 = Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))
        self.temporal_conv2 = Conv3d(channels, channels, (3, 1, 1), padding=(2, 0, 0),
                                     dilation=(2, 1, 1))
        self.temporal_alpha = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        bt, c, h, w = x.shape
        t = self.num_frames
        v = x.reshape(bt // t, t, c, h, w).permute(0, 2, 1, 3, 4)
        res = self.temporal_conv1(v) + self.temporal_conv2(v)
        res = res.permute(0, 2, 1, 3, 4).reshape(bt, c, h, w)
        gate = torch.sigmoid(self.temporal_alpha).to(x.dtype)
        return gate * res.to(x.dtype) + (1 - gate) * x


class _TemporalQKV(nn.Module):
    def __init__(self, channels: int, inner: int):
        super().__init__()
        self.to_q = Linear(channels, inner, bias=False)
        self.to_k = Linear(channels, inner, bias=False)
        self.to_v = Linear(channels, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, channels), nn.Dropout(0.0))


class TemporalAttention(nn.Module):
    """Self-attention over T at each pixel: (B*T, C, H, W) -> (B*H*W, T, C)
    -> LayerNorm (eps 1e-6) -> MHA -> alpha blend."""

    def __init__(self, channels: int, num_frames: int, num_heads: int, dim_head: int):
        super().__init__()
        self.num_frames = num_frames
        self.num_heads = num_heads
        self.dim_head = dim_head
        self.norm = LayerNorm(channels, eps=1e-6)
        self.temporal_attn = _TemporalQKV(channels, num_heads * dim_head)
        self.temporal_alpha = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        bt, c, h, w = x.shape
        t = self.num_frames
        b = bt // t
        seq = x.reshape(b, t, c, h * w).permute(0, 3, 1, 2).reshape(b * h * w, t, c)
        y = self.norm(seq)
        a = self.temporal_attn

        def heads(z):
            return z.reshape(b * h * w, t, self.num_heads, self.dim_head)

        attn = attention_math(heads(a.to_q(y)), heads(a.to_k(y)), heads(a.to_v(y)))
        res = a.to_out(attn.reshape(b * h * w, t, -1))
        res = res.reshape(b, h * w, t, c).permute(0, 2, 3, 1).reshape(bt, c, h, w)
        alpha = self.temporal_alpha.to(x.dtype)
        return alpha * res.to(x.dtype) + (1 - alpha) * x

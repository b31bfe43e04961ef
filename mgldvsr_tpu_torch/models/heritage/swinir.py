"""SwinIR, the image restoration transformer (classical SR, pixel-shuffle
upsampling).

Counterpart of ``mgldvsr_tpu/models/heritage/swinir.py``: shallow conv
features, residual Swin transformer blocks (window attention with a
relative position bias, every other block on windows shifted by half a
window, an MLP), a conv after the body, pixel-shuffle reconstruction and a
global mean shift. Tokens are NHWC ([B, H, W, C]) between the convs, as in
JAX; the shifted windows roll by ``-shift`` before the attention and back
after it, and their mask is built for each input size. Input sizes must be
multiples of the window. Keys are basicsr's (``patch_embed.norm``,
``layers.{i}.residual_group.blocks.{j}.attn.qkv`` ..., ``upsample.{2k}``);
the relative position index and the mask are not stored.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.models.heritage.sr_archs import nchw, nhwc

_MEAN = (0.4488, 0.4371, 0.4040)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B,H,W,C] -> [B*nW, ws*ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=32)
def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """[nW, ws*ws, ws*ws] of 0 / -100: no attention across the seams of
    the rolled image."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wss, :] = cnt
            cnt += 1
    m = img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
    m = m.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window_size)),
                             persistent=False)

    def forward(self, x, mask=None):
        bnw, n, c = x.shape
        hd = self.dim // self.num_heads
        q, k, v = (z.reshape(bnw, n, self.num_heads, hd).transpose(1, 2)
                   for z in self.qkv(x).chunk(3, dim=-1))
        attn = (q @ k.transpose(-2, -1)) * hd ** -0.5
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(n, n, self.num_heads).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bnw // nw, nw, self.num_heads, n, n) + mask[None, :, None]
            attn = attn.reshape(bnw, self.num_heads, n, n)
        out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(bnw, n, self.dim)
        return self.proj(out)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 8, shift_size: int = 0,
                 mlp_ratio: float = 2.0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):  # [B,H,W,C]
        b, h, w, c = x.shape
        ws = self.window_size
        shift = self.shift_size if min(h, w) > ws else 0
        y = self.norm1(x)
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = torch.from_numpy(shift_attn_mask(h, w, ws, shift)).to(x.device, x.dtype)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class _ResidualGroup(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2)
            for i in range(depth)])

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class RSTB(nn.Module):
    """Residual Swin transformer block: ``depth`` Swin blocks, a conv, the
    skip."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int = 8):
        super().__init__()
        self.residual_group = _ResidualGroup(dim, depth, num_heads, window_size)
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        return x + nhwc(self.conv(nchw(self.residual_group(x))))


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)


class SwinIR(nn.Module):
    """``forward(x [B,H,W,3] in [0, 1])`` -> [B, sH, sW, 3]; H and W
    multiples of ``window_size``."""

    def __init__(self, upscale: int = 4, embed_dim: int = 60, depths: Sequence[int] = (2, 2),
                 num_heads: Sequence[int] = (6, 6), window_size: int = 8, num_out_ch: int = 3):
        super().__init__()
        self.conv_first = nn.Conv2d(3, embed_dim, 3, padding=1)
        self.patch_embed = _PatchEmbed(embed_dim)
        self.layers = nn.ModuleList([RSTB(embed_dim, d, nh, window_size)
                                     for d, nh in zip(depths, num_heads)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, padding=1)
        self.conv_before_upsample = nn.Sequential(nn.Conv2d(embed_dim, 64, 3, padding=1),
                                                  nn.LeakyReLU(0.01))
        ups, up = [], upscale
        while up > 1:
            r = 3 if up % 3 == 0 else 2
            ups += [nn.Conv2d(64, 64 * r * r, 3, padding=1), nn.PixelShuffle(r)]
            up //= r
        self.upsample = nn.Sequential(*ups)
        self.conv_last = nn.Conv2d(64, num_out_ch, 3, padding=1)

    def forward(self, x):
        mean = torch.tensor(_MEAN, dtype=x.dtype, device=x.device)
        feat = self.conv_first(nchw(x - mean))
        y = self.patch_embed.norm(nhwc(feat))
        for layer in self.layers:
            y = layer(y)
        feat = feat + self.conv_after_body(nchw(self.norm(y)))
        out = self.conv_last(self.upsample(self.conv_before_upsample(feat)))
        return nhwc(out) + mean

"""Transformer blocks of the denoiser and the legacy qkv attention block.

Counterpart of ``mgldvsr_tpu/models/attention_blocks.py``, laid out as the
upstream torch modules (SpatialTransformer / BasicTransformerBlock /
CrossAttention, and the OpenAI AttentionBlock with its head-interleaved
qkv conv1d) so their state-dict keys match. All attention goes through
:func:`mgldvsr_tpu_torch.ops.attention.attend`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.models.layers import Conv1d, GroupNorm, LayerNorm, Linear, conv1x1
from mgldvsr_tpu_torch.ops.attention import attend


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when ``context`` is None. A
    context batch smaller than the query batch is repeated to match."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, query_dim), nn.Dropout(0.0))

    def forward(self, x, context: Optional[torch.Tensor] = None):
        ctx = x if context is None else context
        if ctx.shape[0] != x.shape[0]:
            ctx = ctx.repeat_interleave(x.shape[0] // ctx.shape[0], dim=0)
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        b, n, _ = q.shape
        m = k.shape[1]
        out = attend(q.reshape(b, n, self.heads, self.dim_head),
                     k.reshape(b, m, self.heads, self.dim_head),
                     v.reshape(b, m, self.heads, self.dim_head))
        return self.to_out(out.reshape(b, n, self.heads * self.dim_head))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward (keys net.0.proj, net.2)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                 Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn(context) -> GEGLU FF with pre-LN residuals
    (LayerNorm eps 1e-6, flax's default)."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 disable_self_attn: bool = False):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.attn1 = CrossAttention(dim, context_dim if disable_self_attn else dim,
                                    heads, dim_head)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.norm3 = LayerNorm(dim, eps=1e-6)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x), context if self.disable_self_attn else None)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Transformer over flattened H*W. ``use_linear``: linear in/out
    projections (the SD 2.1 ``use_linear_in_transformer`` flavour), else
    1x1 convs (weights [inner, c, 1, 1]) as SD 1.x has them."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int,
                 context_dim: int, dtype=torch.float32, use_linear: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.use_linear = use_linear
        self.norm = GroupNorm(channels, eps=1e-6, dtype=dtype)
        self.proj_in = Linear(channels, inner) if use_linear else conv1x1(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)])
        self.proj_out = Linear(inner, channels) if use_linear else conv1x1(inner, channels)

    def forward(self, x, context=None):
        n, c, h, w = x.shape
        y = self.norm(x)
        if self.use_linear:
            y = self.proj_in(y.reshape(n, c, h * w).transpose(1, 2))
        else:
            y = self.proj_in(y)
            y = y.reshape(n, y.shape[1], h * w).transpose(1, 2)
        for block in self.transformer_blocks:
            y = block(y, context)
        if self.use_linear:
            y = self.proj_out(y).transpose(1, 2).reshape(n, c, h, w)
        else:
            y = self.proj_out(y.transpose(1, 2).reshape(n, -1, h, w))
        return y + x


class QKVAttentionBlock(nn.Module):
    """OpenAI AttentionBlock: GroupNorm -> qkv conv1d -> MHA -> proj_out.
    The qkv channels are head-interleaved ([H, 3, d]) as upstream's
    ``QKVAttentionLegacy`` lays them out."""

    def __init__(self, channels: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm(channels, dtype=dtype)
        self.qkv = Conv1d(channels, 3 * channels, 1)
        self.proj_out = Conv1d(channels, channels, 1)

    def forward(self, x):
        n, c, h, w = x.shape
        heads = self.num_heads
        dh = c // heads
        qkv = self.qkv(self.norm(x).reshape(n, c, h * w))      # [N, 3C, T]
        qkv = qkv.reshape(n, heads, 3, dh, h * w).permute(2, 0, 4, 1, 3)  # [3,N,T,H,d]
        out = attend(qkv[0], qkv[1], qkv[2])                   # [N, T, H, d]
        out = self.proj_out(out.reshape(n, h * w, c).transpose(1, 2))
        return x + out.reshape(n, c, h, w)

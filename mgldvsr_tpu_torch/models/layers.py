"""Shared building blocks (NCHW, upstream torch state-dict key names).

Counterpart of ``mgldvsr_tpu/models/layers.py``. Convolutions and linears
cast their input to their weight's dtype, as flax's ``dtype=`` does, so a
tower runs in the dtype its weights were cast to by :func:`cast_weights`;
norms keep float32 parameters.

GroupNorm has the JAX package's two semantics. In float32 it is flax's
``nn.GroupNorm`` (float32 mean of x and x^2 per group). In a low-precision
dtype it is the bandwidth-lean one-pass form: per-channel float32 sums of
the low-precision input, folded into groups, and one fused scale-shift in
the input dtype. ``MGLD_GN_FP32=1`` forces the float32 semantics
everywhere, read when a GroupNorm is built.

On a CUDA tensor both run as kernels: a 4-D low-precision input with
H*W >= 16384 (the VAE's 128^2 and larger levels) takes the channel-sums
kernel, exactly where the JAX module does, and everything else the fused
GroupNorm kernel. The JAX package wrote that second kernel too but left it
undispatched, because pulling GroupNorm out of XLA's conv+norm fusion made
the TPU program slower; eager PyTorch has no such fusion to lose, and the
plain form is about eight small launches per call. On a CPU tensor both
keep their plain code.

``MGLD_FUSED_GN_CONV`` (read at call time; ``1``/``true``/``on``, or
``auto`` = on for CUDA tensors) sends every 4-D GroupNorm -> SiLU -> conv3x3
chain through the one-kernel :func:`gn_silu_conv3x3`; the modules and their
state-dict keys are the same either way.
"""
from __future__ import annotations

import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.ops.kernels.gn_silu_conv import gn_silu_conv3x3
from mgldvsr_tpu_torch.ops.kernels.groupnorm import (
    channel_sums,
    fused_group_norm,
    group_scale_shift,
)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class Conv1d(nn.Conv1d):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class Conv3d(nn.Conv3d):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class Linear(nn.Linear):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed and returned in float32 (flax ``dtype=float32``)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


_COMPUTE_LAYERS = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)


def cast_weights(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the conv and linear layers of ``module`` to ``dtype`` in place,
    leaving norms and embeddings in float32."""
    for m in module.modules():
        if isinstance(m, _COMPUTE_LAYERS):
            m.to(dtype)
    return module


def conv3x3(cin: int, cout: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1)


def conv1x1(cin: int, cout: int) -> Conv2d:
    return Conv2d(cin, cout, 1)


def gn_fp32_forced() -> bool:
    return os.environ.get("MGLD_GN_FP32") == "1"


class GroupNorm(nn.Module):
    """GroupNorm over [N, C, *spatial] with affine ``weight``/``bias``."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.dtype = torch.float32 if gn_fp32_forced() else dtype
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        if self.dtype == torch.float32:
            return group_norm_fp32(x, self.weight, self.bias, self.num_groups, self.eps)
        return group_norm_lean(x, self.weight, self.bias, self.num_groups, self.eps,
                               self.dtype)


def group_norm_fp32(x, weight, bias, groups: int, eps: float) -> torch.Tensor:
    """flax ``nn.GroupNorm`` semantics: float32 stats (E[x^2] - E[x]^2,
    clipped at 0) and a float32 result. On a CUDA tensor: the fused
    GroupNorm kernel on ``x.float()``."""
    n, c = x.shape[:2]
    xf = x.float()
    if x.device.type == "cuda":
        return fused_group_norm(xf.contiguous(), weight, bias, groups, eps)
    xg = xf.reshape(n, groups, -1)
    mean = xg.mean(dim=-1, keepdim=True)
    var = ((xg * xg).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (xg - mean) * torch.rsqrt(var + eps)
    shape = (1, c) + (1,) * (x.ndim - 2)
    return y.reshape(x.shape) * weight.float().reshape(shape) + bias.float().reshape(shape)


def group_norm_lean(x, weight, bias, groups: int, eps: float, dtype) -> torch.Tensor:
    """One-pass low-precision GroupNorm: fp32 channel sums of the ``dtype``
    input, group fold on [N, C], one scale-shift in ``dtype``. On a CUDA
    tensor: the channel-sums kernel for a 4-D input with H*W >= 16384, the
    fused GroupNorm kernel otherwise."""
    x = x.to(dtype)
    n, c = x.shape[:2]
    big = x.ndim == 4 and x.shape[2] * x.shape[3] >= 16384
    if x.device.type == "cuda" and not big:
        return fused_group_norm(x.contiguous(), weight, bias, groups, eps)
    spatial = tuple(range(2, x.ndim))
    if big:
        s1, s2 = channel_sums(x.contiguous())
    else:
        s1 = x.sum(dim=spatial, dtype=torch.float32)
        s2 = (x * x).sum(dim=spatial, dtype=torch.float32)
    count = float(x[0, 0].numel() * (c // groups))
    a, b = group_scale_shift(s1, s2, count, weight, bias, groups, eps)
    shape = (n, c) + (1,) * (x.ndim - 2)
    return x * a.to(dtype).reshape(shape) + b.to(dtype).reshape(shape)


def fused_gn_conv_enabled(x: torch.Tensor) -> bool:
    """``MGLD_FUSED_GN_CONV``: ``1``/``true``/``on`` force the fused
    GroupNorm+SiLU+conv kernel on, ``auto`` turns it on for a CUDA tensor,
    anything else (default ``0``) leaves it off. Read at call time."""
    flag = os.environ.get("MGLD_FUSED_GN_CONV", "0").lower()
    if flag in ("1", "true", "on"):
        return True
    if flag == "auto":
        return x.device.type == "cuda"
    return False


def norm_silu_conv(norm: GroupNorm, conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(silu(norm(x)))`` for a 3x3, stride-1, padding-1 ``conv``: one
    fused kernel when the switch is on and ``x`` is 4-D, else the plain
    composition of the two modules. Both read the same parameters."""
    if x.ndim == 4 and fused_gn_conv_enabled(x):
        dtype = conv.weight.dtype
        return gn_silu_conv3x3(x.to(dtype).contiguous(), norm.weight, norm.bias, conv.weight,
                               conv.bias, norm.num_groups, norm.eps)
    return conv(F.silu(norm(x)))


def norm_silu_conv3x3(cin: int, cout: int, dtype, eps: float = 1e-5) -> nn.Sequential:
    """GroupNorm, SiLU, 3x3 conv as children (keys .0, .2); run it with
    ``norm_silu_conv(seq[0], seq[2], x)``."""
    return nn.Sequential(GroupNorm(cin, eps=eps, dtype=dtype), nn.SiLU(), conv3x3(cin, cout))


class Upsample(nn.Module):
    """2x nearest upsample followed by a 3x3 conv (key ``conv``)."""

    def __init__(self, channels: int, out_channels: int | None = None):
        super().__init__()
        self.conv = conv3x3(channels, out_channels or channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Downsample(nn.Module):
    """UNet downsample: stride-2 3x3 conv with symmetric padding (key ``op``)."""

    def __init__(self, channels: int, out_channels: int | None = None):
        super().__init__()
        self.op = conv3x3(channels, out_channels or channels, stride=2)

    def forward(self, x):
        return self.op(x)


class VAEDownsample(nn.Module):
    """SD-VAE downsample: (0,1) pad then a stride-2 3x3 valid conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


def timestep_embed_mlp(in_dim: int, dim: int) -> nn.Sequential:
    """linear -> SiLU -> linear (keys .0, .2)."""
    return nn.Sequential(Linear(in_dim, dim), nn.SiLU(), Linear(dim, dim))


class UNetResBlock(nn.Module):
    """OpenAI-UNet residual block with additive timestep conditioning
    (keys in_layers.{0,2}, emb_layers.1, out_layers.{0,3}, skip_connection)."""

    def __init__(self, cin: int, cout: int, emb_channels: int, dtype=torch.float32):
        super().__init__()
        self.in_layers = norm_silu_conv3x3(cin, cout, dtype)
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_channels, cout))
        # norm, SiLU, dropout 0, conv: children kept for their keys (.0, .3)
        self.out_layers = nn.Sequential(GroupNorm(cout, dtype=dtype), nn.SiLU(),
                                        nn.Dropout(0.0), conv3x3(cout, cout))
        self.skip_connection = conv1x1(cin, cout) if cin != cout else nn.Identity()

    def residual(self, x, emb):
        h = norm_silu_conv(self.in_layers[0], self.in_layers[2], x)
        h = h + self.emb_layers(emb)[:, :, None, None].to(h.dtype)
        return norm_silu_conv(self.out_layers[0], self.out_layers[3], h)

    def forward(self, x, emb):
        h = self.residual(x, emb)
        return self.skip_connection(x) + h


class VAEResnetBlock(nn.Module):
    """SD-VAE residual block, GroupNorm eps 1e-6 (keys norm1, conv1, norm2,
    conv2, nin_shortcut)."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(cin, eps=1e-6, dtype=dtype)
        self.conv1 = conv3x3(cin, cout)
        self.norm2 = GroupNorm(cout, eps=1e-6, dtype=dtype)
        self.conv2 = conv3x3(cout, cout)
        if cin != cout:
            self.nin_shortcut = conv1x1(cin, cout)

    def forward(self, x):
        h = norm_silu_conv(self.norm1, self.conv1, x)
        h = norm_silu_conv(self.norm2, self.conv2, h)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over spatial positions (VAE mid)."""

    def __init__(self, c: int, dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm(c, eps=1e-6, dtype=dtype)
        self.q = conv1x1(c, c)
        self.k = conv1x1(c, c)
        self.v = conv1x1(c, c)
        self.proj_out = conv1x1(c, c)

    def forward(self, x):
        from mgldvsr_tpu_torch.ops.attention import attend

        n, c, h, w = x.shape
        y = self.norm(x)

        def seq(t):
            return t.reshape(n, c, h * w).transpose(1, 2)[:, :, None, :]

        attn = attend(seq(self.q(y)), seq(self.k(y)), seq(self.v(y)))
        attn = attn[:, :, 0, :].transpose(1, 2).reshape(n, c, h, w)
        return x + self.proj_out(attn)

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

``MGLD_INT8_CONV=1`` (read when a conv is built, by :func:`conv3x3`) makes
every 3x3 conv that the JAX package builds with its ``conv3x3()`` an
:class:`Int8Conv3x3` (the JAX name): the towers' convs, res-block convs,
``Downsample.op``, SPADE's three, the RDB's five and the ``conv_in`` of
each tower. ``Upsample.conv`` (the JAX package's phase-decomposed conv),
``VAEDownsample``, the temporal and the 1x1 convs stay as they are, and so
does a chain that ``MGLD_FUSED_GN_CONV`` sends to the fused kernel. The JAX
package reads the switch while tracing; the port reads it once, when the
module is built, so a tower built under it runs int8 whatever the variable
says later, and a tower built without it never does. The state-dict keys
are ``Conv2d``'s either way.

``MGLD_FUSED_GN_CONV`` (read at call time; ``1``/``true``/``on``, or
``auto`` = on for CUDA tensors) sends every 4-D GroupNorm -> SiLU -> conv3x3
chain through the one-kernel :func:`gn_silu_conv3x3`; the modules and their
state-dict keys are the same either way. Under tensor parallelism
(:mod:`mgldvsr_tpu_torch.parallel.tensor`) a chain's conv holds its rank's
output channels: the kernel takes that slice of the weight and of the bias,
reads the whole input for its GroupNorm statistics, and the output is
gathered.
"""
from __future__ import annotations

import itertools
import os
from typing import Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.ops.kernels.gn_silu_conv import gn_silu_conv3x3, tensor_state
from mgldvsr_tpu_torch.ops.kernels.groupnorm import (
    channel_sums,
    fused_group_norm,
    group_scale_shift,
)
from mgldvsr_tpu_torch.ops.kernels.int8_conv import int8_conv3x3, quantize_weight, weight_levels
from mgldvsr_tpu_torch.parallel.tensor import ColumnParallel, copy_to_group, gather_columns


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


def int8_conv_enabled() -> bool:
    """``MGLD_INT8_CONV=1``: :func:`conv3x3` builds :class:`Int8Conv3x3`."""
    return os.environ.get("MGLD_INT8_CONV") == "1"


class Int8Conv3x3(Conv2d):
    """3x3 conv, padding 1, on int8 levels (``MGLD_INT8_CONV=1``): a dynamic
    activation scale over the whole input, one weight scale an output
    channel, int32 sums, float32 dequantisation and bias, the output in the
    weight's (the tower's) dtype; the input is quantized in its own dtype,
    as in the JAX module. Keys and shapes are ``Conv2d``'s.

    The levels come from the **float32** weight and bias, as in the JAX
    package, whose parameters stay float32: a float32 weight gives them at
    call time (cached until it changes); a weight cast to a low-precision
    dtype by ``.to()`` (:func:`cast_weights`) keeps the levels, scales and
    float32 bias derived just before the cast, and ``load_state_dict`` of a
    float32 state dict into a low-precision module derives them from the
    incoming tensors. A low-precision weight without them (changed in place
    since, or loaded from a low-precision state dict) raises: the levels are
    never taken from a rounded weight. Training is not ported (the JAX
    module's gradient reaches only the scales and the bias): a call that
    would record a gradient raises."""

    tensor_parallel_refused = ("an int8 conv has no column-parallel form (int8 training is "
                               "not ported)")

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(cin, cout, 3, stride=stride, padding=1)
        self._levels = None   # (states of weight and bias, kq, sw, float32 bias)
        self._pending = None  # levels of a state dict being loaded
        self.register_load_state_dict_pre_hook(Int8Conv3x3._levels_from_state_dict)
        self.register_load_state_dict_post_hook(Int8Conv3x3._levels_after_load)

    def _states(self) -> tuple:
        return tensor_state(self.weight), tensor_state(self.bias)

    def _keep(self, kq, sw, bias) -> None:
        dev = self.weight.device
        self._levels = (self._states(), kq.to(dev), sw.to(dev), bias.detach().float().to(dev))

    def levels(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(kq int8 [Co,C,3,3], sw float32 [Co], bias float32 [Co])."""
        if self.weight.dtype == torch.float32:
            return (*weight_levels(self.weight), self.bias.float())
        lv = self._levels
        if lv is None or lv[0] != self._states():
            raise RuntimeError(
                f"Int8Conv3x3: the {self.weight.dtype} weight has no int8 levels taken from its "
                f"float32 values; cast the module from float32 (.to()) or load a float32 state "
                f"dict into it after changing the weight (the levels are never taken from a "
                f"rounded weight)")
        return lv[1:]

    def _apply(self, fn, recurse=True):
        keep = None
        if not self.weight.is_meta:
            if self.weight.dtype == torch.float32:
                keep = (*quantize_weight(self.weight), self.bias.detach().clone())
            elif self._levels is not None and self._levels[0] == self._states():
                keep = self._levels[1:]
        out = super()._apply(fn, recurse)
        self._levels = None
        if keep is not None and not self.weight.is_meta:
            self._keep(*keep)
        return out

    def _levels_from_state_dict(self, state_dict, prefix, *_):
        w, b = state_dict.get(prefix + "weight"), state_dict.get(prefix + "bias")
        self._pending = None
        if (isinstance(w, torch.Tensor) and w.dtype == torch.float32 and not w.is_meta
                and isinstance(b, torch.Tensor)):
            self._pending = (*quantize_weight(w), b.detach().float().clone())

    def _levels_after_load(self, _incompatible):
        if self._pending is not None:
            self._keep(*self._pending)
        self._pending = None

    def forward(self, x):
        if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad
                                        or self.bias.requires_grad):
            raise RuntimeError(
                "Int8Conv3x3: MGLD_INT8_CONV has no training path in the port (ROADMAP §1, "
                "\"int8 training\": the JAX module's gradient reaches only the scales and the "
                "bias); run it under torch.no_grad() or with frozen weights and inputs")
        kq, sw, bias = self.levels()
        return int8_conv3x3(x.contiguous(), kq, sw, bias, self.stride[0], self.weight.dtype)


def conv3x3(cin: int, cout: int, stride: int = 1) -> Conv2d:
    """A 3x3 conv, padding 1: :class:`Int8Conv3x3` when
    ``MGLD_INT8_CONV=1`` at this call, else ``Conv2d``. Every site where the
    JAX package calls its ``conv3x3()`` builds through here."""
    if int8_conv_enabled():
        return Int8Conv3x3(cin, cout, stride)
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
    composition of the two modules. Both read the same parameters. A
    column-parallel ``conv`` gives the kernel its rows of the weight and the
    bias, then gathers the output channels; the input and the GroupNorm's
    parameters pass ``copy_to_group``, since each rank's slice gives a part
    of their gradients."""
    if x.ndim == 4 and fused_gn_conv_enabled(x):
        x = x.to(conv.weight.dtype).contiguous()
        if not isinstance(conv, ColumnParallel):
            return gn_silu_conv3x3(x, norm.weight, norm.bias, conv.weight, conv.bias,
                                   norm.num_groups, norm.eps)
        grid, rows = conv.tensor_parallel, conv.weight.shape[0]
        x, gn_weight, gn_bias, bias = copy_to_group(grid, x, norm.weight, norm.bias, conv.bias)
        bias = bias.narrow(0, grid.tensor_index * rows, rows).float()
        return gather_columns(gn_silu_conv3x3(x, gn_weight, gn_bias, conv.weight, bias,
                                              norm.num_groups, norm.eps), 1, grid)
    return conv(F.silu(norm(x)))


def norm_silu_conv3x3(cin: int, cout: int, dtype, eps: float = 1e-5) -> nn.Sequential:
    """GroupNorm, SiLU, 3x3 conv as children (keys .0, .2); run it with
    ``norm_silu_conv(seq[0], seq[2], x)``."""
    return nn.Sequential(GroupNorm(cin, eps=eps, dtype=dtype), nn.SiLU(), conv3x3(cin, cout))


class Upsample(nn.Module):
    """2x nearest upsample followed by a 3x3 conv (key ``conv``; never int8:
    the JAX package's is its phase-decomposed conv, not ``conv3x3()``)."""

    def __init__(self, channels: int, out_channels: int | None = None):
        super().__init__()
        self.conv = Conv2d(channels, out_channels or channels, 3, padding=1)

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


def dropout(x: torch.Tensor, p: float, seed: int) -> torch.Tensor:
    """flax ``nn.Dropout(p)`` in training: each element kept with
    probability 1 - p and scaled by 1 / (1 - p), else zero. The mask comes
    from a generator seeded with ``seed`` on ``x``'s device, so a block
    recomputed in the backward (``use_checkpoint``) draws the same mask."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def dropout_seeds(seed: Optional[int]) -> Optional[Iterator[int]]:
    """The res blocks' dropout seeds of one forward: seed, seed + 1, ...
    in call order, or None (no dropout)."""
    return None if seed is None else itertools.count(seed)


def next_seed(seeds: Optional[Iterator[int]]) -> Optional[int]:
    return None if seeds is None else next(seeds)


def norm_silu_dropout_conv(norm: GroupNorm, conv: Conv2d, x: torch.Tensor, p: float,
                           seed) -> torch.Tensor:
    """``conv(dropout(silu(norm(x))))`` where ``seed`` is given and ``p`` >
    0 (the JAX blocks' ``deterministic=False`` branch), else
    :func:`norm_silu_conv`. The fused GroupNorm+SiLU+conv chain has no
    dropout between its SiLU and its conv, so a block that drops runs the
    three apart."""
    if p and seed is not None:
        return conv(dropout(F.silu(norm(x)), p, seed))
    return norm_silu_conv(norm, conv, x)


class UNetResBlock(nn.Module):
    """OpenAI-UNet residual block with additive timestep conditioning
    (keys in_layers.{0,2}, emb_layers.1, out_layers.{0,3}, skip_connection).
    ``dropout`` acts before the second conv when a ``dropout_seed`` is
    passed (training), never otherwise."""

    def __init__(self, cin: int, cout: int, emb_channels: int, dtype=torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.in_layers = norm_silu_conv3x3(cin, cout, dtype)
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_channels, cout))
        # norm, SiLU, dropout, conv: children kept for their keys (.0, .3)
        self.out_layers = nn.Sequential(GroupNorm(cout, dtype=dtype), nn.SiLU(),
                                        nn.Dropout(dropout), conv3x3(cout, cout))
        self.skip_connection = conv1x1(cin, cout) if cin != cout else nn.Identity()

    def residual(self, x, emb, dropout_seed=None):
        h = norm_silu_conv(self.in_layers[0], self.in_layers[2], x)
        h = h + self.emb_layers(emb)[:, :, None, None].to(h.dtype)
        return norm_silu_dropout_conv(self.out_layers[0], self.out_layers[3], h, self.dropout,
                                      dropout_seed)

    def forward(self, x, emb, dropout_seed=None):
        h = self.residual(x, emb, dropout_seed)
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

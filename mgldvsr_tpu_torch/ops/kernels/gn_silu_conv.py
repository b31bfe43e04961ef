"""GroupNorm + SiLU + 3x3 conv in one CUDA kernel, and its plain version.

Replaces ``mgldvsr_tpu/ops/pallas/gn_silu_conv.py`` (``gn_silu_conv3x3``
over ``_fused_fwd_impl``, kernel ``_kernel``). It is arithmetic-bound on the
H100: 18 * C * Co flops per pixel against 2 * (C + Co) bytes. As in the JAX
package the group statistics are taken outside the kernel, here by the
channel-sums kernel (one read of x) and a fold on [N, C] data, and arrive as
one fp32 (scale, shift) per (frame, channel); the kernel
(``csrc/gn_silu_conv.cu``) normalises, applies SiLU, rounds to the working
dtype and convolves as an implicit GEMM tiled through shared memory, so the
normalised activation is never written to device memory. The TPU kernel
held a whole frame in fast memory and fell back to the plain composition
where it did not fit; this one tiles and takes every shape, so there is no
size guard and no fallback.

A CPU tensor takes the plain version; a CUDA tensor launches the kernels
or raises. The gradient is autograd through the plain version on the saved
inputs, as in the JAX package (which has no backward kernel either).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mgldvsr_tpu_torch.ops.kernels import _build
from mgldvsr_tpu_torch.ops.kernels.groupnorm import (
    _recompute_grads,
    channel_sums,
    group_scale_shift,
)

_ENTRY = {torch.bfloat16: "mgld_gn_silu_conv_bf16", torch.float16: "mgld_gn_silu_conv_f16",
          torch.float32: "mgld_gn_silu_conv_f32"}


def gn_silu_conv3x3_plain(x: torch.Tensor, gn_weight: torch.Tensor, gn_bias: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor, groups: int = 32,
                          eps: float = 1e-5) -> torch.Tensor:
    """Plain version (the JAX ``xla_gn_silu_conv3x3``): fp32 statistics
    (E[x^2] - E[x]^2, clipped at 0) and normalisation, SiLU, cast to x's
    dtype, 3x3 conv with zero padding, bias added in fp32, cast to x's
    dtype. x [N,C,H,W], weight [Co,C,3,3]."""
    n, c, h, w = x.shape
    xg = x.float().reshape(n, groups, -1)
    mean = xg.mean(dim=-1, keepdim=True)
    var = ((xg * xg).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, c, h, w)
    xn = xn * gn_weight.float().reshape(1, c, 1, 1) + gn_bias.float().reshape(1, c, 1, 1)
    xn = F.silu(xn).to(x.dtype)
    out = F.conv2d(xn, weight.to(x.dtype), None, stride=1, padding=1)
    return (out.float() + bias.float().reshape(1, -1, 1, 1)).to(x.dtype)


def _launch(x, gn_weight, gn_bias, weight, bias, groups: int, eps: float) -> torch.Tensor:
    n, c, h, w = x.shape
    co = weight.shape[0]
    s1, s2 = channel_sums(x)
    scale, shift = group_scale_shift(s1, s2, float(h * w * (c // groups)), gn_weight, gn_bias,
                                     groups, eps)
    scale, shift = scale.contiguous(), shift.contiguous()
    bias32 = bias.float().contiguous()
    out = torch.empty(n, co, h, w, dtype=x.dtype, device=x.device)
    fn = getattr(_build.library(), _ENTRY[x.dtype])
    err = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), weight.data_ptr(),
             bias32.data_ptr(), out.data_ptr(), n, c, h, w, co, _build.stream_ptr(x.device))
    _build.check(err, _ENTRY[x.dtype])
    gn_silu_conv3x3.launches += 1
    return out


class _GNSiLUConv(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the plain version on the
    saved inputs."""

    @staticmethod
    def forward(ctx, x, gn_weight, gn_bias, weight, bias, groups, eps):
        ctx.save_for_backward(x, gn_weight, gn_bias, weight, bias)
        ctx.groups, ctx.eps = groups, eps
        with torch.no_grad():
            return _launch(x, gn_weight, gn_bias, weight, bias, groups, eps)

    @staticmethod
    def backward(ctx, g):
        return (*_recompute_grads(
            lambda *a: gn_silu_conv3x3_plain(*a, groups=ctx.groups, eps=ctx.eps),
            ctx.saved_tensors, g, ctx.needs_input_grad[:5]), None, None)


def gn_silu_conv3x3(x: torch.Tensor, gn_weight: torch.Tensor, gn_bias: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor, groups: int = 32,
                    eps: float = 1e-5) -> torch.Tensor:
    """conv3x3(SiLU(GroupNorm(x))), zero padding 1, stride 1, for a
    contiguous x [N,C,H,W] in bfloat16, float16 or float32 and a contiguous
    weight [Co,C,3,3] of the same dtype; float32 ``gn_weight``, ``gn_bias``
    [C] and ``bias`` [Co]. Output [N,Co,H,W] in x's dtype."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_plain(x, gn_weight, gn_bias, weight, bias, groups, eps)
    if x.ndim != 4 or not x.is_contiguous() or x.device.type != "cuda":
        raise ValueError(f"gn_silu_conv3x3: need a contiguous CUDA [N,C,H,W] tensor, got "
                         f"{tuple(x.shape)} (contiguous={x.is_contiguous()}) on {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"gn_silu_conv3x3: bfloat16, float16 or float32 only, got {x.dtype}")
    c = x.shape[1]
    if weight.ndim != 4 or weight.shape[1:] != (c, 3, 3) or not weight.is_contiguous():
        raise ValueError(f"gn_silu_conv3x3: need a contiguous [Co,{c},3,3] weight, got "
                         f"{tuple(weight.shape)} (contiguous={weight.is_contiguous()})")
    if weight.dtype != x.dtype:
        raise TypeError(f"gn_silu_conv3x3: weight is {weight.dtype}, x is {x.dtype}")
    if c % groups or gn_weight.shape != (c,) or gn_bias.shape != (c,) \
            or bias.shape != (weight.shape[0],):
        raise ValueError(f"gn_silu_conv3x3: {c} channels, {groups} groups, GroupNorm affine "
                         f"{tuple(gn_weight.shape)}/{tuple(gn_bias.shape)}, bias "
                         f"{tuple(bias.shape)} for {weight.shape[0]} output channels")
    if any(t.device != x.device for t in (gn_weight, gn_bias, weight, bias)):
        raise ValueError("gn_silu_conv3x3: every tensor must be on x's device")
    args = (x, gn_weight, gn_bias, weight, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _GNSiLUConv.apply(*args, groups, eps)
    return _launch(*args, groups, eps)


gn_silu_conv3x3.launches = 0

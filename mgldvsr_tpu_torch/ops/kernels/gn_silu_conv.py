"""GroupNorm + SiLU + 3x3 conv as one chain of two launches from one host
call, and its plain version.

Replaces ``mgldvsr_tpu/ops/pallas/gn_silu_conv.py`` (``gn_silu_conv3x3``
over ``_fused_fwd_impl``, kernel ``_kernel``). It is arithmetic-bound on the
H100: 18 * C * Co flops per pixel against 2 * (C + Co) bytes. As in the JAX
package the group statistics are taken outside the conv kernel: one launch
(``groupnorm.gn_scale_shift``'s kernel) reads x once and writes the folded
fp32 (scale, shift) per (frame, channel) into a scratch from PyTorch's
allocator; one C call enqueues it and the conv kernel, and the wrapper
counts one launch of each. The conv kernel (``csrc/gn_silu_conv.cu``)
normalises, applies SiLU, rounds to the working dtype and convolves as an
implicit GEMM tiled through shared memory, so the normalised activation is
never written to device memory. The TPU kernel held a whole frame in fast
memory and fell back to the plain composition where it did not fit; this one
tiles and takes every shape, so there is no size guard and no fallback.

Three kernels serve it (``kernel_variant``): bfloat16 with more than 8 output
channels, every chain of the full-width restore but the output convs, runs
on ``wgmma``; float16 and the few-channel output convs on ``mma.sync``;
float32 (the parity mode) on the FMA units. The ``wgmma`` kernel reads the
weight tap-major and channel-contiguous, ``[9][Co][Cp]`` with Cp = C rounded
up to 64 (``relaid_weight``). That copy is made once per weight tensor and
kept in a cache beside the module's own ``[Co, C, 3, 3]`` parameter, which
stays the only copy in the state dict; an in-place update or a
``load_state_dict`` of the parameter makes the next call lay it out again.
A conv bias that was cast to the working dtype with its weight gets its
float32 copy from the same cache, so a warm chain copies nothing.

A CPU tensor takes the plain version; a CUDA tensor launches the kernels
or raises. The gradient is autograd through the plain version on the saved
inputs, as in the JAX package (which has no backward kernel either).
"""
from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

from mgldvsr_tpu_torch.ops.kernels import _build
from mgldvsr_tpu_torch.ops.kernels.groupnorm import (
    check_group_affine,
    gn_scale_shift,
    group_affine_ok,
    recompute_grads,
)

# the C entries of the conv kernel alone, on ready statistics (timing and
# tests): the mma.sync kernel (bf16, f16) and the FMA kernel (f32) take the
# weight as it is (the wgmma kernel's, mgld_gn_silu_conv_wgmma_bf16, takes it
# re-laid); and of the whole chain (statistics, then conv) in one call
_ENTRY = {torch.bfloat16: "mgld_gn_silu_conv_bf16", torch.float16: "mgld_gn_silu_conv_f16",
          torch.float32: "mgld_gn_silu_conv_f32"}
_CHAIN_ENTRY = {torch.bfloat16: "mgld_gn_silu_conv_chain_bf16",
                torch.float16: "mgld_gn_silu_conv_chain_f16",
                torch.float32: "mgld_gn_silu_conv_chain_f32"}
_WGMMA_CHAIN_ENTRY = "mgld_gn_silu_conv_chain_wgmma_bf16"
STAGE_CHANNELS = 64  # input channels per stage of the wgmma kernel


def kernel_variant(dtype: torch.dtype, co: int) -> str:
    """Which kernel a chain takes: ``"wgmma"`` for bfloat16 with more than 8
    output channels, ``"fma"`` for float32, ``"mma"`` (``mma.sync``) for
    float16 and for bfloat16 with up to 8 output channels."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if dtype == torch.bfloat16 and co > 8 else "mma"


def relayout_weight(weight: torch.Tensor) -> torch.Tensor:
    """``[Co, C, 3, 3]`` -> ``[9, Co, Cp]``: tap-major, channels contiguous,
    Cp = C rounded up to a multiple of 64 with zeros beyond C."""
    co, c = weight.shape[:2]
    cp = -(-c // STAGE_CHANNELS) * STAGE_CHANNELS
    out = weight.new_zeros(9, co, cp)
    out[:, :, :c] = weight.detach().permute(2, 3, 0, 1).reshape(9, co, c)
    return out


_DERIVED: dict[tuple, tuple] = {}  # (id(tensor), what) -> (weak reference, state, copy)


def tensor_state(tensor: torch.Tensor) -> tuple:
    """What changes when a tensor's values may have: its address, version
    counter, shape, dtype and device."""
    return (tensor.data_ptr(), tensor._version, tuple(tensor.shape), tensor.dtype, tensor.device)


def _derived(tensor: torch.Tensor, what: str, make) -> torch.Tensor:
    """``make(tensor)``, computed at the first call and again after the tensor
    changed (:func:`tensor_state`); the cache entry goes when the tensor
    does."""
    key = (id(tensor), what)
    entry = _DERIVED.get(key)
    state = tensor_state(tensor)
    if entry is not None and entry[0]() is tensor and entry[1] == state:
        return entry[2]
    made = make(tensor)
    _DERIVED[key] = (weakref.ref(tensor, lambda _, key=key: _DERIVED.pop(key, None)), state, made)
    _derived.made += 1
    return made


_derived.made = 0  # copies made so far (a warm path makes none)


def derived_bytes() -> tuple[int, int]:
    """(tensors, bytes) that the cache holds now."""
    copies = [t for entry in _DERIVED.values()
              for t in (entry[2] if isinstance(entry[2], tuple) else (entry[2],))]
    return len(copies), sum(t.numel() * t.element_size() for t in copies)


def relaid_weight(weight: torch.Tensor) -> torch.Tensor:
    """The cached ``relayout_weight(weight)``."""
    return _derived(weight, "relaid", relayout_weight)


def bias_fp32(bias: torch.Tensor) -> torch.Tensor:
    """The bias as the kernels take it, float32: itself, or a cached copy of
    a conv bias that was cast to the working dtype with its weight."""
    if bias.dtype == torch.float32:
        return bias
    return _derived(bias, "fp32", lambda t: t.detach().float())


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
    """Both kernels from one C call: the statistics into one fp32 [2, N, C]
    scratch (scale, then shift), then the conv kernel on them."""
    n, c, h, w = x.shape
    co = weight.shape[0]
    stats = torch.empty(2 * n * c, dtype=torch.float32, device=x.device)
    out = torch.empty(n, co, h, w, dtype=x.dtype, device=x.device)
    bias = bias_fp32(bias)
    wgmma = kernel_variant(x.dtype, co) == "wgmma"
    head = (x.data_ptr(), gn_weight.data_ptr(), gn_bias.data_ptr(), stats.data_ptr())
    if wgmma:
        relaid = relaid_weight(weight)
        name = _WGMMA_CHAIN_ENTRY
        fn, stream = _build.bind(name)
        err = fn(*head, relaid.data_ptr(), bias.data_ptr(), out.data_ptr(), n, c,
                 relaid.shape[2], h, w, co, groups, eps, stream(x.get_device()))
    else:
        name = _CHAIN_ENTRY[x.dtype]
        fn, stream = _build.bind(name)
        err = fn(*head, weight.data_ptr(), bias.data_ptr(), out.data_ptr(), n, c, h, w, co,
                 groups, eps, stream(x.get_device()))
    if err:
        _build.check(err, name)
    gn_scale_shift.launches += 1
    gn_silu_conv3x3.launches += 1
    gn_silu_conv3x3.wgmma_launches += wgmma
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
        return (*recompute_grads(
            lambda *a: gn_silu_conv3x3_plain(*a, groups=ctx.groups, eps=ctx.eps),
            ctx.saved_tensors, g, ctx.needs_input_grad[:5]), None, None)


def gn_silu_conv3x3(x: torch.Tensor, gn_weight: torch.Tensor, gn_bias: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor, groups: int = 32,
                    eps: float = 1e-5) -> torch.Tensor:
    """conv3x3(SiLU(GroupNorm(x))), zero padding 1, stride 1, for a
    contiguous x [N,C,H,W] in bfloat16, float16 or float32 and a contiguous
    weight [Co,C,3,3] of the same dtype; contiguous float32 ``gn_weight``
    and ``gn_bias`` [C]; ``bias`` [Co] in float32 or x's dtype. Output
    [N,Co,H,W] in x's dtype."""
    if not x.is_cuda and x.device.type == "cpu":
        return gn_silu_conv3x3_plain(x, gn_weight, gn_bias, weight, bias, groups, eps)
    if not (x.is_cuda and x.ndim == 4 and x.is_contiguous() and x.dtype in _ENTRY
            and weight.dtype is x.dtype and weight.ndim == 4
            and weight.shape[1:] == (x.shape[1], 3, 3) and weight.is_contiguous()
            and weight.get_device() == x.get_device()
            and group_affine_ok(x, gn_weight, gn_bias, groups)
            and bias.shape == (weight.shape[0],) and bias.get_device() == x.get_device()
            and (bias.dtype is torch.float32 or bias.dtype is x.dtype) and bias.is_contiguous()):
        _check(x, gn_weight, gn_bias, weight, bias, groups)
    if torch.is_grad_enabled() and (x.requires_grad or gn_weight.requires_grad
                                    or gn_bias.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GNSiLUConv.apply(x, gn_weight, gn_bias, weight, bias, groups, eps)
    return _launch(x, gn_weight, gn_bias, weight, bias, groups, eps)


def _check(x, gn_weight, gn_bias, weight, bias, groups: int) -> None:
    """Raise with the reason where ``gn_silu_conv3x3`` refuses its input."""
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
    check_group_affine("gn_silu_conv3x3", x, gn_weight, gn_bias, groups)
    if bias.shape != (weight.shape[0],):
        raise ValueError(f"gn_silu_conv3x3: bias {tuple(bias.shape)} for {weight.shape[0]} "
                         f"output channels")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("gn_silu_conv3x3: every tensor must be on x's device")
    if bias.dtype not in (torch.float32, x.dtype) or not bias.is_contiguous():
        raise ValueError(f"gn_silu_conv3x3: bias must be contiguous float32 or {x.dtype}, got "
                         f"{bias.dtype} (contiguous={bias.is_contiguous()})")
    raise ValueError("gn_silu_conv3x3: input refused")  # every failing condition raised above


gn_silu_conv3x3.launches = 0
gn_silu_conv3x3.wgmma_launches = 0  # of them on the tensor-core (wgmma) kernel

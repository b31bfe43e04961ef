"""Guidance warp: CUDA forward and input-gradient kernels, and their plain
versions.

Replaces ``mgldvsr_tpu/ops/pallas/flow_warp.py``: ``pallas_flow_warp``
(forward) and ``_pallas_warp_dx`` (the gradient), wrapped together as
``flow_warp_guided``, for a warp called on its own. The restore's guidance
step does not come here: ``ops/kernels/guidance.py`` computes the whole
gradient of the warp loss, these taps included, in two launches of its own.
Both share the tap arithmetic of ``csrc/warp_taps.cuh``, so the forward
equals its plain version bit for bit. The forward of 3-channel frames (the
swc loss's and E*warp's) is a tiled gather, a 16 x 64 tile a block and four
pixels a thread with their flow loads issued first (``csrc/flow_warp.cu``);
4-channel latents take one thread a pixel with a float4 a tap. The gradient
is a 4-tap fp32 ``atomicAdd`` scatter (its summation order varies between
runs).

The launch path is short, because a call at the swc loss's shape takes
about 10 us on the device: the checks are one compound test (the detailed
message is built only when it fails), the C entry and the stream getter are
bound once (``_build.bind``), and the stream comes from the device index.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``warp_forward`` has no gradient of its own: on the card it raises
when autograd would need one (use ``flow_warp_guided``). The flow's gradient
is zero by contract, as in the JAX package: guidance differentiates with
respect to the latents only.
"""
from __future__ import annotations

import torch

from mgldvsr_tpu_torch.ops.kernels import _build
from mgldvsr_tpu_torch.ops.warp import bilinear_taps, flow_warp


def warp_plain(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel: the gather warp."""
    return flow_warp(x, flow)


def warp_dx_plain(g: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain version of the gradient kernel: the transpose of the warp as a
    4-tap ``index_add_`` scatter."""
    n, h, w, c = g.shape
    x0, y0, tx, ty = bilinear_taps(flow)
    tx = tx.to(g.dtype)
    ty = ty.to(g.dtype)
    batch = torch.arange(n, device=g.device)[:, None, None] * (h * w)
    dx = torch.zeros(n * h * w, c, dtype=g.dtype, device=g.device)
    for yy, xx, wt in ((y0, x0, (1 - tx) * (1 - ty)), (y0, x0 + 1, tx * (1 - ty)),
                       (y0 + 1, x0, (1 - tx) * ty), (y0 + 1, x0 + 1, tx * ty)):
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = (batch + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))[ok]
        dx.index_add_(0, idx, (g * (wt * ok)[..., None])[ok])
    return dx.reshape(n, h, w, c)


_F32 = torch.float32
_LIMIT = 2 ** 31  # elements a tensor may have: the kernels' index arithmetic is 32-bit


def _check(name: str, a: torch.Tensor, flow: torch.Tensor) -> None:
    """Raise with the reason where ``_takes`` refuses ``a`` and ``flow``."""
    if a.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError(f"{name}: float32 tensors only, got {a.dtype} and {flow.dtype}")
    if a.ndim != 4 or tuple(flow.shape) != (*a.shape[:3], 2):
        raise ValueError(f"{name}: need x [N,H,W,C] and flow [N,H,W,2], got "
                         f"{tuple(a.shape)} and {tuple(flow.shape)}")
    if a.device != flow.device or a.device.type != "cuda":
        raise ValueError(f"{name}: both tensors must be on one CUDA device")
    if not (a.is_contiguous() and flow.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    if max(a.numel(), flow.numel()) >= _LIMIT:
        raise ValueError(f"{name}: {a.numel()} and {flow.numel()} elements; the kernel takes "
                         f"under 2^31")


def _takes(a: torch.Tensor, flow: torch.Tensor) -> bool:
    """Every condition of ``_check`` as one cheap test, ``a`` on the card."""
    return (a.dtype is _F32 and flow.dtype is _F32 and a.ndim == 4
            and flow.shape == (*a.shape[:3], 2) and flow.is_cuda
            and flow.get_device() == a.get_device() and a.is_contiguous()
            and flow.is_contiguous() and a.numel() < _LIMIT and flow.numel() < _LIMIT)


def _launch(name: str, a: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The kernel ``name`` on checked tensors: a new output like ``a``."""
    out = torch.empty_like(a)
    n, h, w, c = a.shape
    fn, stream = _build.bind(name)
    err = fn(a.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h, w, c, stream(a.get_device()))
    if err:
        _build.check(err, name)
    return out


def warp_forward(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(p) = x(p + flow(p)), zeros outside. x [N,H,W,C], flow [N,H,W,2]."""
    if not x.is_cuda and x.device.type == "cpu":
        return warp_plain(x, flow)
    if torch.is_grad_enabled() and (x.requires_grad or flow.requires_grad):
        raise RuntimeError("warp_forward: the CUDA kernel has no gradient; use "
                           "flow_warp_guided for a warp that autograd differentiates")
    if not (x.is_cuda and _takes(x, flow)):
        _check("warp_forward", x, flow)
    out = _launch("mgld_warp_fwd_f32", x, flow)
    warp_forward.launches += 1
    return out


def warp_dx(g: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """dL/dx of :func:`warp_forward` given the output cotangent ``g``."""
    if not g.is_cuda and g.device.type == "cpu":
        return warp_dx_plain(g, flow)
    if not (g.is_cuda and _takes(g, flow)):
        _check("warp_dx", g, flow)
    dx = _launch("mgld_warp_dx_f32", g, flow)
    warp_dx.launches += 1
    return dx


warp_forward.launches = 0
warp_dx.launches = 0


class _GuidedWarp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, flow):
        ctx.save_for_backward(flow)
        return warp_forward(x.contiguous(), flow.contiguous())

    @staticmethod
    def backward(ctx, g):
        (flow,) = ctx.saved_tensors
        return warp_dx(g.contiguous(), flow.contiguous()), None


def flow_warp_guided(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp whose backward gives dL/dx only (the flow gets no gradient)."""
    return _GuidedWarp.apply(x, flow)

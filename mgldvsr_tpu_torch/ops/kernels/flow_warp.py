"""Guidance warp: CUDA forward and input-gradient kernels, and their plain
versions.

Replaces ``mgldvsr_tpu/ops/pallas/flow_warp.py``: ``pallas_flow_warp``
(forward) and ``_pallas_warp_dx`` (the gradient), wrapped together as
``flow_warp_guided``, for a warp called on its own. The restore's guidance
step does not come here: ``ops/kernels/guidance.py`` computes the whole
gradient of the warp loss, these taps included, in two launches of its own.
Both share the tap arithmetic of ``csrc/warp_taps.cuh``. The call is tiny
and latency-bound (``csrc/flow_warp.cu``), so the forward is a direct 4-tap
gather, one thread a pixel, and the gradient a 4-tap fp32 ``atomicAdd``
scatter (its summation order varies between runs).

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


def _check(name: str, a: torch.Tensor, flow: torch.Tensor) -> None:
    if a.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError(f"{name}: float32 tensors only, got {a.dtype} and {flow.dtype}")
    if a.ndim != 4 or tuple(flow.shape) != (*a.shape[:3], 2):
        raise ValueError(f"{name}: need x [N,H,W,C] and flow [N,H,W,2], got "
                         f"{tuple(a.shape)} and {tuple(flow.shape)}")
    if a.device != flow.device or a.device.type != "cuda":
        raise ValueError(f"{name}: both tensors must be on one CUDA device")
    if not (a.is_contiguous() and flow.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    if a.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {a.numel()} elements; the kernel takes under 2^31")


def warp_forward(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(p) = x(p + flow(p)), zeros outside. x [N,H,W,C], flow [N,H,W,2]."""
    if x.device.type == "cpu":
        return warp_plain(x, flow)
    if torch.is_grad_enabled() and (x.requires_grad or flow.requires_grad):
        raise RuntimeError("warp_forward: the CUDA kernel has no gradient; use "
                           "flow_warp_guided for a warp that autograd differentiates")
    _check("warp_forward", x, flow)
    out = torch.empty_like(x)
    n, h, w, c = x.shape
    err = _build.library().mgld_warp_fwd_f32(
        x.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h, w, c,
        _build.stream_ptr(x.device))
    _build.check(err, "mgld_warp_fwd_f32")
    warp_forward.launches += 1
    return out


def warp_dx(g: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """dL/dx of :func:`warp_forward` given the output cotangent ``g``."""
    if g.device.type == "cpu":
        return warp_dx_plain(g, flow)
    _check("warp_dx", g, flow)
    dx = torch.empty_like(g)
    n, h, w, c = g.shape
    err = _build.library().mgld_warp_dx_f32(
        g.data_ptr(), flow.data_ptr(), dx.data_ptr(), n, h, w, c,
        _build.stream_ptr(g.device))
    _build.check(err, "mgld_warp_dx_f32")
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

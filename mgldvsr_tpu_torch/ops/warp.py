"""Optical-flow backward warping and flow resizing.

Counterpart of ``mgldvsr_tpu/ops/warp.py``: ``x`` is [N,H,W,C], ``flow`` is
[N,H,W,2] with ``flow[...,0]`` the x displacement, sampled with
align_corners=True semantics. Written as clamped gathers plus a bilinear
blend (not ``grid_sample``), so it is differentiable by autograd and its
arithmetic is the JAX function's.
"""
from __future__ import annotations

import torch

from mgldvsr_tpu_torch.ops.resize import resize2d


def _gather2d(x: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """x[n, iy[n,h,w], ix[n,h,w], :] -> [N,H,W,C] with clipped indices."""
    n, h, w, c = x.shape
    idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    flat = x.reshape(n, h * w, c)
    out = torch.gather(flat, 1, idx.reshape(n, h * w, 1).expand(n, h * w, c))
    return out.reshape(n, h, w, c)


def bilinear_taps(flow: torch.Tensor):
    """Integer base tap and blend weights of ``p + flow(p)`` per pixel:
    (x0, y0) int64 [N,H,W] and (tx, ty) float [N,H,W]."""
    n, h, w, _ = flow.shape
    gx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
    gy = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    px = gx + flow[..., 0]
    py = gy + flow[..., 1]
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    # clamp before the cast so far-out samples cannot overflow; every tap
    # of a clamped base lies outside the image and reads zero
    x0i = x0.clamp(-2, w + 1).to(torch.int64)
    y0i = y0.clamp(-2, h + 1).to(torch.int64)
    return x0i, y0i, px - x0, py - y0


def flow_warp(x: torch.Tensor, flow: torch.Tensor, interp_mode: str = "bilinear",
              padding_mode: str = "zeros", return_mask: bool = False):
    """out(p) = x(p + flow(p)); outside samples are zero (``zeros``) or
    clamped to the border (``border``)."""
    n, h, w, c = x.shape
    if tuple(flow.shape) != (n, h, w, 2):
        raise ValueError(f"flow {tuple(flow.shape)} does not match x {tuple(x.shape)}")
    if interp_mode == "nearest":
        gx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
        gy = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
        ix = torch.round(gx + flow[..., 0]).to(torch.int64)
        iy = torch.round(gy + flow[..., 1]).to(torch.int64)
        valid = ((ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1))[..., None].to(x.dtype)
        out = _gather2d(x, iy, ix)
        if padding_mode == "zeros":
            out = out * valid
        return (out, valid) if return_mask else out

    x0i, y0i, tx, ty = bilinear_taps(flow)
    tx = tx.to(x.dtype)[..., None]
    ty = ty.to(x.dtype)[..., None]
    if padding_mode == "border":
        v00 = _gather2d(x, y0i, x0i)
        v01 = _gather2d(x, y0i, x0i + 1)
        v10 = _gather2d(x, y0i + 1, x0i)
        v11 = _gather2d(x, y0i + 1, x0i + 1)
        gx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
        gy = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
        txc = (gx + flow[..., 0]).clamp(0, w - 1)
        tyc = (gy + flow[..., 1]).clamp(0, h - 1)
        tx = (txc - torch.floor(txc))[..., None].to(x.dtype)
        ty = (tyc - torch.floor(tyc))[..., None].to(x.dtype)
    else:
        def tap(yy, xx):
            inside = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
            return _gather2d(x, yy, xx) * inside[..., None].to(x.dtype)

        v00, v01 = tap(y0i, x0i), tap(y0i, x0i + 1)
        v10, v11 = tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    out = top * (1 - ty) + bot * ty
    if not return_mask:
        return out

    def inside(yy, xx):
        return ((xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
                ).to(x.dtype)[..., None]

    ones = ((inside(y0i, x0i) * (1 - tx) + inside(y0i, x0i + 1) * tx) * (1 - ty)
            + (inside(y0i + 1, x0i) * (1 - tx) + inside(y0i + 1, x0i + 1) * tx) * ty)
    return out, (ones >= 0.9999).to(x.dtype)


def resize_flow(flow: torch.Tensor, size_type: str, sizes, interp_mode: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """Resize a [N,H,W,2] flow, scaling each component by its axis ratio
    before interpolating."""
    n, h, w, _ = flow.shape
    if size_type == "ratio":
        out_h, out_w = int(h * sizes[0]), int(w * sizes[1])
    elif size_type == "shape":
        out_h, out_w = int(sizes[0]), int(sizes[1])
    else:
        raise ValueError(f"size_type must be ratio or shape, got {size_type}")
    ratio = torch.tensor([out_w / w, out_h / h], dtype=flow.dtype, device=flow.device)
    return resize2d(flow * ratio, (out_h, out_w), method=interp_mode,
                    align_corners=align_corners)

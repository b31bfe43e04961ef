"""Clip-level flows and occlusion masks for motion guidance.

Counterpart of ``mgldvsr_tpu/flow/compute.py``. For a [B, T, H, W, 3] clip,
``flows_backward[k] = flownet(frame_k, frame_{k+1})`` and
``flows_forward[k] = flownet(frame_{k+1}, frame_k)``, both directions in
one batched flownet call.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from mgldvsr_tpu_torch.ops.occlusion import forward_backward_consistency_check
from mgldvsr_tpu_torch.ops.warp import resize_flow


def compute_clip_flows(flownet: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                       frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames [B,T,H,W,3] in [0,1] -> (flows_forward, flows_backward), each
    [B,T-1,H,W,2]."""
    b, t, h, w, c = frames.shape
    former = frames[:, :-1].reshape(b * (t - 1), h, w, c)
    latter = frames[:, 1:].reshape(b * (t - 1), h, w, c)
    flows = flownet(torch.cat([former, latter], 0), torch.cat([latter, former], 0))
    flows_backward = flows[: b * (t - 1)].reshape(b, t - 1, h, w, 2)
    flows_forward = flows[b * (t - 1):].reshape(b, t - 1, h, w, 2)
    return flows_forward, flows_backward


def chunked_pairs(fn: Callable, chunk: Optional[int]) -> Callable:
    """Run a per-pair batched net over groups of ``chunk`` pairs, bounding
    peak activation memory (the correlation volumes). Pairs are independent
    through the net, so the output equals the one-shot batch. ``chunk`` 0 or
    None is one call over every pair, as in the JAX package; a negative
    ``chunk`` raises ``ValueError``."""
    if not chunk:
        return fn
    if chunk < 0:
        raise ValueError(f"flow chunk must be a count of pairs >= 0 or None, got {chunk}")

    def wrapped(a, b):
        if a.shape[0] <= chunk:
            return fn(a, b)
        return torch.cat([fn(a[i:i + chunk], b[i:i + chunk])
                          for i in range(0, a.shape[0], chunk)], dim=0)

    return wrapped


def compute_occlusion_masks(flows_forward: torch.Tensor, flows_backward: torch.Tensor,
                            alpha: float = 0.01, beta: float = 0.5):
    """Per-pair masks [B,T-1,H,W,1], 1 = occluded; ``flows_forward`` is the
    'fwd' argument of the check, as in the reference script."""
    b, tm1, h, w, _ = flows_forward.shape
    fwd_occ, bwd_occ = forward_backward_consistency_check(
        flows_forward.reshape(b * tm1, h, w, 2), flows_backward.reshape(b * tm1, h, w, 2),
        alpha, beta)
    return fwd_occ.reshape(b, tm1, h, w, 1), bwd_occ.reshape(b, tm1, h, w, 1)


def flows_to_latent_res(flows: torch.Tensor, scale: float = 0.125) -> torch.Tensor:
    """Resize a [B,T-1,H,W,2] flow stack by ``scale`` with magnitude
    rescaling."""
    b, tm1, h, w, _ = flows.shape
    out = resize_flow(flows.reshape(b * tm1, h, w, 2), "ratio", (scale, scale))
    return out.reshape(b, tm1, out.shape[1], out.shape[2], 2)

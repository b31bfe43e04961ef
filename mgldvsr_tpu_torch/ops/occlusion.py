"""Forward-backward flow consistency (occlusion) check, UnFlow style.

Counterpart of ``mgldvsr_tpu/ops/occlusion.py``. Flows are [N,H,W,2]; the
masks are [N,H,W,1] with 1 = occluded.
"""
from __future__ import annotations

import torch

from mgldvsr_tpu_torch.ops.warp import flow_warp


def forward_backward_consistency_check(fwd_flow: torch.Tensor, bwd_flow: torch.Tensor,
                                       alpha: float = 0.01, beta: float = 0.5):
    if fwd_flow.ndim != 4 or fwd_flow.shape[-1] != 2:
        raise ValueError(f"expected [N,H,W,2] flows, got {tuple(fwd_flow.shape)}")

    def norm(f):
        return torch.sqrt(torch.sum(f * f, dim=-1))

    flow_mag = norm(fwd_flow) + norm(bwd_flow)
    diff_fwd = norm(fwd_flow + flow_warp(bwd_flow, fwd_flow))
    diff_bwd = norm(bwd_flow + flow_warp(fwd_flow, bwd_flow))
    threshold = alpha * flow_mag + beta
    fwd_occ = (diff_fwd > threshold).to(fwd_flow.dtype)[..., None]
    bwd_occ = (diff_bwd > threshold).to(fwd_flow.dtype)[..., None]
    return fwd_occ, bwd_occ

"""Temporal consistency metric E*warp (warping error).

Counterpart of ``mgldvsr_tpu/metrics/temporal.py``: the paper's E*warp
(arXiv 2312.00853), the mean over consecutive pairs of the squared error
between each frame and its neighbour warped back onto it by the flow,
occluded pixels masked out. Lower is better.

On the card the flows are RAFT's (its lookup is kernel 4 when ``flownet``
is the port's RAFT), run over groups of ``chunk_pairs`` frame pairs
(``flow/compute.chunked_pairs``: the correlation volumes of a long clip's
pairs do not fit at once), and the warp of every pair is one launch of
kernel 1 (``ops/kernels/flow_warp.warp_forward``); a CPU tensor takes the
kernel's plain version. The JAX package warps with plain XLA.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from mgldvsr_tpu_torch.flow.compute import (
    chunked_pairs,
    compute_clip_flows,
    compute_occlusion_masks,
)
from mgldvsr_tpu_torch.ops.kernels.flow_warp import warp_forward


@torch.no_grad()
def calculate_ewarp(frames_01, flownet: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    chunk_pairs: Optional[int] = 8,
                    device: Optional[str | torch.device] = None) -> float:
    """frames [T, H, W, 3] in [0,1] (a tensor, or numpy moved to ``device``).
    Returns the mean over the T-1 pairs of each pair's occlusion-masked
    mean squared error."""
    if not torch.is_tensor(frames_01):
        frames_01 = torch.from_numpy(np.asarray(frames_01))
    frames = frames_01.to(device=device, dtype=torch.float32)
    ff, fb = compute_clip_flows(chunked_pairs(flownet, chunk_pairs), frames[None])
    fwd_occ, _ = compute_occlusion_masks(ff, fb)
    # frame i+1 warped back onto frame i by the backward flow, every pair in one call
    warped = warp_forward(frames[1:].contiguous(), fb[0].contiguous())
    mask = 1.0 - fwd_occ[0]
    err = torch.sum(mask * (warped - frames[:-1]) ** 2, dim=(1, 2, 3)) / (
        torch.sum(mask, dim=(1, 2, 3)) * frames.shape[-1] + 1e-8)
    return float(np.mean(err.tolist()))

"""Attention dispatch: where the hand-written attention kernel is taken.

Counterpart of ``mgldvsr_tpu/ops/attention.py``. Self-attention with
N == M >= 1024 whose shape passes the JAX gate (``pick_block_q`` nonzero:
the UNet and struct-cond spatial attention at 64^2 and 32^2 latents) goes
to :func:`mgldvsr_tpu_torch.ops.kernels.attention.attention_bnhd`. Every
other call (cross-attention, temporal attention, the VAE's d=512 mid
attention) uses the plain fp32-softmax matmul math.

The gated calls are bound by operations on the H100, and they are most of
a sampler step's device time. At full width (bfloat16, head dim 64) they
run on the tensor cores, and the kernel reads q, k and v through their
[B, N, H, D] strides: the UNet's ``CrossAttention`` hands over views of its
[B, N, H*D] projections, which are read in place, and the result comes back
[B, N, H, D] contiguous, so merging the heads is a view too. The
struct-cond encoder's ``QKVAttentionBlock`` views have stride N in D; those
are copied once each. float32 and other head dims take the FMA kernel over
folded copies.
"""
from __future__ import annotations

import torch

from mgldvsr_tpu_torch.ops.kernels.attention import attention_bnhd, pick_block_q


def attention_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """q [B,N,H,D], k/v [B,M,H,D] -> [B,N,H,D]; logits and softmax in fp32.
    ``mask`` (broadcastable to [B,H,N,M], True = keep) hides keys."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k).to(torch.float32) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B,N,H,D], k/v [B,M,H,D] -> [B,N,H,D], softmax in fp32."""
    b, n, h, d = q.shape
    m = k.shape[1]
    if n == m and n >= 1024 and pick_block_q(n, d, q.element_size()):
        return attention_bnhd(q, k, v)
    return attention_math(q, k, v)

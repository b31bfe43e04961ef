"""Attention dispatch: where the hand-written attention kernel is taken.

Counterpart of ``mgldvsr_tpu/ops/attention.py``. Self-attention with
N == M >= 1024 whose shape passes the JAX gate (``pick_block_q`` nonzero:
the UNet and struct-cond spatial attention at 64^2 and 32^2 latents, and
the VAE's d=512 mid attention at 32^2 to 57^2 latents in bf16 and to 45^2
in float32, frames of 256 to 456 px) goes to
:func:`mgldvsr_tpu_torch.ops.kernels.attention.attention_bnhd`. Every
other call (cross-attention, temporal attention, the VAE's mid attention
at 64^2 latents and more) uses the plain fp32-softmax matmul math.

The gated calls are bound by operations on the H100, and they are most of
a sampler step's device time. At full width (bfloat16, head dim 64) they
run on the tensor cores, and the kernel reads q, k and v through their
[B, N, H, D] strides: the UNet's ``CrossAttention`` hands over views of its
[B, N, H*D] projections, which are read in place, and the result comes back
[B, N, H, D] contiguous, so merging the heads is a view too. The
struct-cond encoder's ``QKVAttentionBlock`` views have stride N in D; those
are copied once each. float32 and other head dims take the FMA kernel over
folded copies, and head dim 512 the wide kernel over folded copies.
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


def gated(n: int, m: int, d: int, itemsize: int) -> bool:
    """Whether :func:`attend` sends a call of N queries, M keys and head dim
    ``d`` to the kernel: the JAX package's gate."""
    return n == m and n >= 1024 and pick_block_q(n, d, itemsize) > 0


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B,N,H,D], k/v [B,M,H,D] -> [B,N,H,D], softmax in fp32."""
    if gated(q.shape[1], k.shape[1], q.shape[-1], q.element_size()):
        return attention_bnhd(q, k, v)
    return attention_math(q, k, v)

"""Self-attention: CUDA kernel with an fp32 online softmax, and its plain
version.

Replaces ``mgldvsr_tpu/ops/pallas/attention.py`` (``resident_attention``,
whose kernel is ``_attn_kernel``). It is arithmetic-bound on the H100 at
the UNet's 64^2 latents: the TPU kernel held a head's K/V resident in fast
memory, which a 227 KB shared-memory block cannot, so the kernel streams
K/V tiles through shared memory with a running max and sum per query
(``csrc/attention.cu``), and never writes the [N, N] logits out. This first
version uses the fp32 FMA units; tensor cores come later.

Forward only: the restore path runs the towers without gradients. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from mgldvsr_tpu_torch.ops.kernels import _build

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)


def pick_block_q(n: int, d: int, itemsize: int, budget: int = 10 * 1024 * 1024) -> int:
    """The JAX package's dispatch gate (``ops/pallas/attention.pick_block_q``)
    kept verbatim, so the kernel serves exactly the calls the TPU kernel
    served: nonzero when a [bq, N] fp32 panel pair plus K/V fit the budget.
    The CUDA kernel has no such limit; only the gate is kept."""
    np_ = (n + 127) // 128 * 128
    kv = 2 * np_ * d * itemsize
    for bq in (512, 256, 128):
        if np_ % bq == 0 and 2 * bq * np_ * 4 + kv <= budget:
            return bq
    return 0


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: [BH,N,D] -> [BH,N,D], logits and softmax in fp32,
    probabilities cast back to the input dtype (the JAX ``_reference``)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnd,bmd->bnm", q, k).to(torch.float32) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnm,bmd->bnd", probs, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v for contiguous [BH, N, D] float32 or
    bfloat16 tensors; output in the input dtype."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if not (q.shape == k.shape == v.shape) or q.ndim != 3:
        raise ValueError(f"attention: q, k, v must share one [BH,N,D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention: float32 or bfloat16 only, got {q.dtype}")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("attention: q, k, v must be on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention: tensors must be contiguous")
    bh, n, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"attention: head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    out = torch.empty_like(q)
    lib = _build.library()
    fn = lib.mgld_attention_f32 if q.dtype == torch.float32 else lib.mgld_attention_bf16
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, n, d,
             float(d ** -0.5), _build.stream_ptr(q.device))
    _build.check(err, "mgld_attention")
    attention.launches += 1
    return out


attention.launches = 0

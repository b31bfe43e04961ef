"""GroupNorm statistics: a Triton one-pass channel-sums kernel and its plain
version.

Replaces ``mgldvsr_tpu/ops/pallas/groupnorm.py``: ``channel_sums`` (kernel
``_stats_kernel``). It is bound by device-memory bandwidth: one read of a
bf16 [N, C, H, W] activation (the VAE's 128^2 to 512^2 levels). Each
program reduces one contiguous H*W row of one (n, c) in fp32 and writes
both sums, so the activation is read once and no fp32 copy of it is ever
materialised; the group fold and scale-shift stay in PyTorch on [N, C]
data.

``triton`` is imported only inside the launching function, so this module
imports where Triton is absent. A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch


def channel_sums_plain(x: torch.Tensor):
    """Plain version: per-(n, c) fp32 sum and sum of squares over H, W of
    an [N, C, H, W] tensor."""
    xf = x.float()
    return xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))


@functools.cache
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def channel_sums_kernel(x_ptr, s1_ptr, s2_ptr, hw, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        base = x_ptr + row.to(tl.int64) * hw
        acc1 = tl.zeros([BLOCK], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, hw, BLOCK):
            offs = start + tl.arange(0, BLOCK)
            v = tl.load(base + offs, mask=offs < hw, other=0.0).to(tl.float32)
            acc1 += v
            acc2 += v * v
        tl.store(s1_ptr + row, tl.sum(acc1, axis=0))
        tl.store(s2_ptr + row, tl.sum(acc2, axis=0))

    return channel_sums_kernel


def channel_sums(x: torch.Tensor):
    """(sum, sum of squares), each [N, C] float32, of a contiguous
    [N, C, H, W] tensor, reduced over H and W in one read."""
    if x.device.type == "cpu":
        return channel_sums_plain(x)
    if x.ndim != 4 or not x.is_contiguous() or x.device.type != "cuda":
        raise ValueError(f"channel_sums: need a contiguous CUDA [N,C,H,W] tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"channel_sums: floating input only, got {x.dtype}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("channel_sums: forward only; call it under torch.no_grad()")
    n, c, h, w = x.shape
    s1 = torch.empty(n, c, dtype=torch.float32, device=x.device)
    s2 = torch.empty(n, c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _triton_kernel()[(n * c,)](x, s1, s2, h * w, BLOCK=2048, num_warps=8)
    channel_sums.launches += 1
    return s1, s2


channel_sums.launches = 0

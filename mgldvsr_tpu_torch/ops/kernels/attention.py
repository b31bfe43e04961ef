"""Self-attention: two CUDA kernels with an fp32 online softmax, and their
plain version.

Replaces ``mgldvsr_tpu/ops/pallas/attention.py`` (``resident_attention``,
whose kernel is ``_attn_kernel``). The work is bound by operations on the
H100 (4 N^2 D flops per head against 4 N D elements moved; at D = 64 the
softmax's exponentials cost about as many clocks as the two products do on
the tensor cores). The TPU kernel held a head's K/V resident in fast memory,
which a 227 KB shared-memory block cannot, so both kernels stream K/V tiles
through shared memory with a running max and sum per query row and never
write the [N, N] logits out (``csrc/attention.cu``).

The wrapper chooses between two hand-written kernels by type and head dim
(:func:`kernel_variant`); this is a dispatch, not a fallback, and a CUDA
tensor launches one of them or raises:

* ``"wgmma"``: bfloat16 at head dim 64, every gated call of the full-width
  restore. Both products run on the tensor cores (``wgmma.mma_async``), the
  probabilities stay in registers, the next K/V tile is fetched by
  ``cp.async`` while the current one is multiplied, and q, k, v are read
  through their [B, N, H, D] strides, so head-interleaved projections need
  no copy and the output is written [B, N, H, D] contiguous.
* ``"fma"``: float32 (the parity mode, no TF32) and bfloat16 at head dims
  8, 16, 32 and 128, on the fp32 FMA units over contiguous [BH, N, D].

Forward only: the restore path runs the towers without gradients. A CPU
tensor takes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from mgldvsr_tpu_torch.ops.kernels import _build

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)


def pick_block_q(n: int, d: int, itemsize: int, budget: int = 10 * 1024 * 1024) -> int:
    """The JAX package's dispatch gate (``ops/pallas/attention.pick_block_q``)
    kept verbatim, so the kernel serves exactly the calls the TPU kernel
    served: nonzero when a [bq, N] fp32 panel pair plus K/V fit the budget.
    The CUDA kernels have no such limit; only the gate is kept."""
    np_ = (n + 127) // 128 * 128
    kv = 2 * np_ * d * itemsize
    for bq in (512, 256, 128):
        if np_ % bq == 0 and 2 * bq * np_ * 4 + kv <= budget:
            return bq
    return 0


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """Which of the two kernels serves a call: ``"wgmma"`` or ``"fma"``."""
    return "wgmma" if dtype == torch.bfloat16 and d == 64 else "fma"


def route(dtype: torch.dtype, shape: tuple[int, ...], strides: tuple[int, ...],
          byte_offset: int = 0) -> bool:
    """Whether the kernel reads one [B, N, H, D] operand of a gated call in
    place. The tensor-core kernel reads a view through its strides when D
    has unit stride and the base (``byte_offset`` from a 16-byte boundary)
    and the batch, row and head strides are multiples of 16 bytes, the size
    of its loads; otherwise the caller copies the view. The FMA kernel takes
    folded contiguous copies only."""
    itemsize = torch.finfo(dtype).bits // 8
    *outer, last = strides
    return (kernel_variant(dtype, shape[-1]) == "wgmma" and last == 1 and byte_offset % 16 == 0
            and all(s * itemsize % 16 == 0 for s in outer))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: [BH,N,D] -> [BH,N,D], logits and softmax in fp32,
    probabilities cast back to the input dtype (the JAX ``_reference``)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnd,bmd->bnm", q, k).to(torch.float32) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnm,bmd->bnd", probs, v)


def _fold(z: torch.Tensor) -> torch.Tensor:
    """[B,N,H,D] -> [B*H,N,D] (a copy unless H is 1)."""
    b, n, h, d = z.shape
    return z.permute(0, 2, 1, 3).reshape(b * h, n, d)


def attention_bnhd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """:func:`attention_plain` per head on [B,N,H,D] -> [B,N,H,D]."""
    b, n, h, d = q.shape
    out = attention_plain(_fold(q), _fold(k), _fold(v))
    return out.reshape(b, h, n, d).permute(0, 2, 1, 3)


def _check(q, k, v, ndim: int, layout: str) -> None:
    if not (q.shape == k.shape == v.shape) or q.ndim != ndim:
        raise ValueError(f"attention: q, k, v must share one {layout} shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention: float32 or bfloat16 only, got {q.dtype}")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("attention: q, k, v must be on one CUDA device")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"attention: head dim {q.shape[-1]} not in {SUPPORTED_HEAD_DIMS}")


def _readable(z: torch.Tensor) -> torch.Tensor:
    """A [B,N,H,64] operand as the tensor-core kernel can read it: itself
    where :func:`route` allows, else a fresh contiguous copy (``clone``, not
    ``contiguous()``, which would hand back a contiguous view whose base is
    off a 16-byte boundary as it is)."""
    if route(z.dtype, z.shape, z.stride(), z.data_ptr()):
        return z
    return z.clone(memory_format=torch.contiguous_format)


def _launch_wgmma(q, k, v, out) -> None:
    """The tensor-core kernel on [B,N,H,64] views: q, k, v as :func:`route`
    allows or as :func:`_readable` copied them, ``out`` with unit stride in
    D. Counts a strided launch when all three operands are read in place."""
    b, n, h, _ = q.shape
    views = (q, k, v)
    q, k, v = (_readable(z) for z in views)
    strides = [s for z in (q, k, v, out) for s in z.stride()[:3]]
    err = _build.library().mgld_attention_wgmma_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n,
        (ctypes.c_longlong * 12)(*strides), 64 ** -0.5, _build.stream_ptr(q.device))
    _build.check(err, "mgld_attention_wgmma_bf16")
    attention.launches += 1
    attention.wgmma_launches += 1
    attention.strided_launches += all(a is z for a, z in zip((q, k, v), views))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v for contiguous [BH, N, D] float32 or
    bfloat16 tensors; output in the input dtype. bfloat16 at head dim 64
    takes the tensor-core kernel (as the case B = 1 of its [B, N, H, D]
    entry), everything else the FMA kernel."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    _check(q, k, v, 3, "[BH,N,D]")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention: tensors must be contiguous")
    bh, n, d = q.shape
    out = torch.empty_like(q)
    if kernel_variant(q.dtype, d) == "wgmma":
        # [BH,N,D] is the case B = 1 of [B,N,H,D] with the heads outermost
        _launch_wgmma(*(z[None].transpose(1, 2) for z in (q, k, v, out)))
        return out
    lib = _build.library()
    fn = lib.mgld_attention_f32 if q.dtype == torch.float32 else lib.mgld_attention_bf16
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, n, d,
             float(d ** -0.5), _build.stream_ptr(q.device))
    _build.check(err, "mgld_attention")
    attention.launches += 1
    return out


def attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The same per head for [B, N, H, D] views -> [B, N, H, D].

    The tensor-core variant reads each operand through its strides where
    :func:`route` allows, copies it otherwise, and writes a
    contiguous [B, N, H, D]; the FMA variant folds all three into contiguous
    [BH, N, D] copies and returns a permuted view."""
    if q.device.type == "cpu":
        return attention_bnhd_plain(q, k, v)
    _check(q, k, v, 4, "[B,N,H,D]")
    b, n, h, d = q.shape
    if kernel_variant(q.dtype, d) == "fma":
        out = attention(*(_fold(z).contiguous() for z in (q, k, v)))
        return out.reshape(b, h, n, d).permute(0, 2, 1, 3)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    _launch_wgmma(q, k, v, out)
    return out


# launches: every launch of either kernel; wgmma_launches: those of the
# tensor-core kernel; strided_launches: those of them that read q, k and v
# in place through their strides, with no copy made
attention.launches = 0
attention.wgmma_launches = 0
attention.strided_launches = 0

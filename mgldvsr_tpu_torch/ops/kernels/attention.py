"""Self-attention: four CUDA kernels with an fp32 online softmax, and their
plain version.

Replaces ``mgldvsr_tpu/ops/pallas/attention.py`` (``resident_attention``,
whose kernel is ``_attn_kernel``). The work is bound by operations on the
H100 (4 N^2 D flops per head against 4 N D elements moved; at D = 64 the
softmax's exponentials cost about as many clocks as the two products do on
the tensor cores). The TPU kernel held a head's K/V resident in fast memory,
which a 227 KB shared-memory block cannot, so the kernels stream K/V tiles
through shared memory with a running max and sum per query row and never
write the [N, N] logits out (``csrc/attention.cu``).

The wrapper chooses between four hand-written kernels by type and head dim
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
* ``"wide_wgmma"``: bfloat16 at head dim 512, the VAE's single-head mid
  attention at frames of 256 to 456 px (the sizes the gate passes it at).
  The ``"wgmma"`` kernel's scheme with 64-column sub-tiles of D; two
  warpgroups own 256 output columns each. It reads one head's operands in
  place in either layout :func:`wide_layout` names: token rows, or the
  VAE's d rows (its q, k, v are NCHW 1x1-conv outputs), which it also
  writes, so the VAE's reshape back to NCHW is a view.
* ``"wide_fma"``: float32 at head dim 512 (the VAE's mid attention at 256
  to 360 px), an FMA kernel tiled in registers over token rows.

A CPU tensor takes the plain version. Where autograd needs a gradient, both
entries go through an autograd Function whose forward is the same call and
whose backward replays the plain version under autograd, as the JAX
``resident_attention``'s ``custom_vjp`` replays its ``_reference``. float16
is not supported on the card: the wrapper raises on it (use bf16 or fp32).
"""
from __future__ import annotations

import ctypes

import torch

from mgldvsr_tpu_torch.ops.kernels import _build
from mgldvsr_tpu_torch.ops.kernels.groupnorm import recompute_grads

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128, 512)
WIDE = 512  # the head dim of the VAE's mid attention, served by the wide kernels


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
    """Which of the four kernels serves a call: ``"wgmma"``, ``"fma"``,
    ``"wide_wgmma"`` or ``"wide_fma"``."""
    if d == WIDE:
        return "wide_wgmma" if dtype == torch.bfloat16 else "wide_fma"
    return "wgmma" if dtype == torch.bfloat16 and d == 64 else "fma"


def wide_layout(dtype: torch.dtype, shape: tuple[int, ...], strides: tuple[int, ...],
                byte_offset: int = 0) -> str | None:
    """How a head-dim-512 kernel reads one [B, N, H, 512] operand in place:
    ``"nd"`` (token rows: unit stride in D), ``"dn"`` (d rows: unit stride
    in N, as the VAE's NCHW conv outputs give them; bfloat16 only, N a
    multiple of 8), or None (the caller copies it into token rows). Either
    needs one head and the base (``byte_offset`` from a 16-byte boundary),
    the row stride and, with more than one batch, the batch stride on
    16-byte boundaries, the size of the kernels' loads."""
    b, n, h, d = shape
    sb, sn, _, sd = strides
    itemsize = torch.finfo(dtype).bits // 8
    if d != WIDE or h != 1 or byte_offset % 16 or (b > 1 and sb * itemsize % 16):
        return None
    if sd == 1 and sn * itemsize % 16 == 0:
        return "nd"
    if dtype == torch.bfloat16 and sn == 1 and sd * itemsize % 16 == 0 and n % 8 == 0:
        return "dn"
    return None


def route(dtype: torch.dtype, shape: tuple[int, ...], strides: tuple[int, ...],
          byte_offset: int = 0) -> bool:
    """Whether the kernel reads one [B, N, H, D] operand of a gated call in
    place. The tensor-core kernel at head dim 64 reads a view through its
    strides when D has unit stride and the base (``byte_offset`` from a
    16-byte boundary) and the batch, row and head strides are multiples of
    16 bytes, the size of its loads; otherwise the caller copies the view.
    At head dim 512 :func:`wide_layout` decides. The FMA kernel takes folded
    contiguous copies only."""
    if shape[-1] == WIDE:
        return wide_layout(dtype, shape, strides, byte_offset) is not None
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
    if q.dtype == torch.float16:
        raise TypeError("attention: fp16 is not supported on the card; use bf16 or fp32")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention: float32 or bfloat16 only, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
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


def _launch_wide(q, k, v) -> torch.Tensor:
    """A head-dim-512 kernel on one head's [B,N,1,512] views -> [B,N,1,512].
    All three in the ``"dn"`` layout are read in place and the output is
    written d rows too (a [B,512,N] tensor, viewed); otherwise each operand
    that is not in ``"nd"`` is copied into token rows, and the output is
    written so. Counts a strided launch when no operand was copied."""
    b, n, _, d = q.shape
    views = (q, k, v)
    layouts = [wide_layout(z.dtype, z.shape, z.stride(), z.data_ptr()) for z in views]
    tok = layouts == ["dn"] * 3
    if tok:
        out = torch.empty((b, d, n), dtype=q.dtype, device=q.device).transpose(1, 2)[:, :, None]
    else:
        q, k, v = (z if lay == "nd" else z.clone(memory_format=torch.contiguous_format)
                   for z, lay in zip(views, layouts))
        out = torch.empty((b, n, 1, d), dtype=q.dtype, device=q.device)
    row = 3 if tok else 1
    strides = (ctypes.c_longlong * 8)(*(s for z in (q, k, v, out)
                                        for s in (z.stride(0), z.stride(row))))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    lib = _build.library()
    if q.dtype == torch.bfloat16:
        err = lib.mgld_attention_wide_bf16(*ptrs, b, n, int(tok), strides, d ** -0.5,
                                           _build.stream_ptr(q.device))
    else:
        err = lib.mgld_attention_wide_f32(*ptrs, b, n, strides, d ** -0.5,
                                          _build.stream_ptr(q.device))
    _build.check(err, "mgld_attention_wide")
    attention.launches += 1
    attention.wide_launches += 1
    attention.wide_strided_launches += all(a is z for a, z in zip((q, k, v), views))
    return out


def _needs_grad(q, k, v) -> bool:
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)


class _Attention(torch.autograd.Function):
    """Forward: the kernel (the plain version for a CPU tensor). Backward:
    autograd of :func:`attention_plain` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _attention(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(attention_plain, ctx.saved_tensors, g, ctx.needs_input_grad)


class _AttentionBNHD(torch.autograd.Function):
    """The same for the [B, N, H, D] entry and :func:`attention_bnhd_plain`."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _attention_bnhd(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(attention_bnhd_plain, ctx.saved_tensors, g,
                               ctx.needs_input_grad)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v for contiguous [BH, N, D] float32 or
    bfloat16 tensors; output in the input dtype. bfloat16 at head dim 64
    takes the tensor-core kernel (as the case B = 1 of its [B, N, H, D]
    entry), head dim 512 a wide kernel (as BH batches of one head),
    everything else the FMA kernel.
    Differentiable: the backward replays the plain version."""
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v)
    return _attention(q, k, v)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    _check(q, k, v, 3, "[BH,N,D]")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention: tensors must be contiguous")
    bh, n, d = q.shape
    if d == WIDE:
        return _launch_wide(*(z[:, :, None] for z in (q, k, v)))[:, :, 0]
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
    contiguous [B, N, H, D]. The wide variants take one head's operands as
    :func:`_launch_wide` says (the VAE's NCHW views in place, their output a
    view of [B, 512, N]); the FMA variant, and the wide ones at more heads,
    fold all three into contiguous [BH, N, D] copies and return a permuted
    view.
    Differentiable: the backward replays the plain version."""
    if _needs_grad(q, k, v):
        return _AttentionBNHD.apply(q, k, v)
    return _attention_bnhd(q, k, v)


def _attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_bnhd_plain(q, k, v)
    _check(q, k, v, 4, "[B,N,H,D]")
    b, n, h, d = q.shape
    if d == WIDE and h == 1:
        return _launch_wide(q, k, v)
    if kernel_variant(q.dtype, d) != "wgmma":
        out = _attention(*(_fold(z).contiguous() for z in (q, k, v)))
        return out.reshape(b, h, n, d).permute(0, 2, 1, 3)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    _launch_wgmma(q, k, v, out)
    return out


# launches: every launch of any of the four kernels; wgmma_launches: those
# of the head-dim-64 tensor-core kernel; strided_launches: those of them that
# read q, k and v in place through their strides, with no copy made;
# wide_launches: those of the two head-dim-512 kernels; wide_strided_launches:
# those of them that read q, k and v in place
attention.launches = 0
attention.wgmma_launches = 0
attention.strided_launches = 0
attention.wide_launches = 0
attention.wide_strided_launches = 0

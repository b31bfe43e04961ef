"""Motion guidance's gradient: the temporal warp loss, its gradient in two
CUDA kernels (launches A and B), and their plain versions.

Every guided sampler step (``core/diffusion.p_sample``) moves the latents
along d/d latents of :func:`temporal_warp_loss`, a sum of occlusion-masked
mean-L1 terms between each frame's latent and a flow-warped neighbour. The
JAX package takes ``jax.grad`` of its ``temporal_warp_loss``
(``mgldvsr_tpu/core/diffusion.py``) through the TPU kernels
``pallas_flow_warp`` (``mgldvsr_tpu/ops/pallas/flow_warp.py:103``) and
``_pallas_warp_dx`` (``:203``). On the card :func:`guidance_grad` is two
kernels (``csrc/guidance.cu``), which take in the loss's arithmetic as well:

* :func:`guidance_residual` (launch A): per (window, frame, pixel), each
  term's warped neighbour by the 4-tap gather, the sign of the residual, the
  frame's direct gradient (a plain store) and each warp's cotangent into a
  scratch buffer;
* :func:`guidance_scatter` (launch B): per (window, warp, pixel), the warp's
  transpose, the cotangent's 4 weighted taps added into a 64-bit fixed-point
  accumulator of the source frame (zeroed by PyTorch), then a finishing
  kernel adds it to the direct part. Integer atomics make the sum
  independent of the order they land in, so the card's restore is the same
  bit for bit from run to run (float atomics were not: ~5e-11 between
  identical calls, which the residuals' sign amplifies over the steps).

The call moves under a megabyte, so both launches sit at a launch's floor;
what they remove is the host's work, the ~170 small launches of the loss and
its autograd graph. Every mode and every ``num_frames`` run the same two
kernels, steered by a term table made once on the host
(:func:`guidance_terms`).

A CPU tensor takes the plain version (:func:`guidance_grad_plain`, autograd
through the loss with the plain warp; each launch has its own plain version,
written the way the kernel loops). A CUDA tensor launches the kernels or
raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Tuple

import torch

from mgldvsr_tpu_torch.ops.kernels import _build
from mgldvsr_tpu_torch.ops.kernels.flow_warp import flow_warp_guided, warp_dx_plain, warp_plain

MODES = ("reference", "aligned")
MAX_FRAMES = 32  # the kernels take the term table by value (csrc/guidance.cu kMaxFrames)

Pair = Tuple[torch.Tensor, torch.Tensor]


def temporal_warp_loss(latents: torch.Tensor, flows: Pair, occs: Pair, num_frames: int,
                       mode: str = "reference",
                       warp: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = flow_warp_guided
                       ) -> torch.Tensor:
    """Bidirectional occlusion-masked flow-warp L1 over a clip's latents.

    latents [(b t), h, w, c]; flows = (forward, backward) each
    [b, t-1, h, w, 2]; occs = (fwd, bwd) each [b, t-1, h, w, 1], 1 =
    occluded. Returns the scalar sum of per-pair mean-L1 terms. ``mode=
    "reference"`` keeps the reference loop's quirks: its first term compares
    against a zero placeholder and its warp is one step stale. ``warp`` is
    the batched warp the terms go through."""
    flow_fwd, flow_bwd = flows
    fwd_occs, bwd_occs = occs
    t = num_frames
    b = latents.shape[0] // t
    lat = latents.reshape(b, t, *latents.shape[1:])

    def l1(a, y):
        return torch.mean(torch.abs(a - y))

    loss = torch.zeros((), dtype=torch.float32, device=latents.device)
    if mode == "reference":
        # all 2(t-2) warps in one call: wb[j] = warp(l_j, fb[j]) and
        # wf[j] = warp(l_j, ff[j-1]) for j in 1..t-2
        wb, wf = {}, {}
        if t > 2:
            js = list(range(1, t - 1))
            src = torch.cat([lat[:, j] for j in js] + [lat[:, j] for j in js], dim=0)
            flo = torch.cat([flow_bwd[:, j] for j in js]
                            + [flow_fwd[:, j - 1] for j in js], dim=0)
            warped = warp(src, flo)
            nb = b * len(js)
            wb = {j: warped[i * b:(i + 1) * b] for i, j in enumerate(js)}
            wf = {j: warped[nb + i * b:nb + (i + 1) * b] for i, j in enumerate(js)}
        zeros = torch.zeros_like(lat[:, 0])
        for k in range(t - 2, -1, -1):
            m = 1.0 - fwd_occs[:, k]
            loss = loss + l1(m * wb.get(k + 1, zeros), m * lat[:, k])
        for k in range(1, t):
            n = 1.0 - bwd_occs[:, k - 1]
            loss = loss + l1(n * wf.get(k - 1, zeros), n * lat[:, k])
    elif mode == "aligned":
        src = torch.cat([lat[:, k + 1] for k in range(t - 1)]
                        + [lat[:, k] for k in range(t - 1)], dim=0)
        flo = torch.cat([flow_bwd[:, k] for k in range(t - 1)]
                        + [flow_fwd[:, k] for k in range(t - 1)], dim=0)
        warped = warp(src, flo)
        nb = b * (t - 1)
        for k in range(t - 1):
            m = 1.0 - fwd_occs[:, k]
            loss = loss + l1(m * warped[k * b:(k + 1) * b], m * lat[:, k])
            n = 1.0 - bwd_occs[:, k]
            loss = loss + l1(n * warped[nb + k * b:nb + (k + 1) * b], n * lat[:, k + 1])
    else:
        raise ValueError(f"unknown temporal loss mode {mode!r}")
    return loss


class Term(NamedTuple):
    """One masked L1 term of :func:`temporal_warp_loss`, at target frame
    ``frame``. ``kind`` 0 is the backward term: mask ``1 - fwd_occs[:, occ]``,
    neighbour warped by ``flow_bwd[:, flow]``; ``kind`` 1 the forward term:
    ``bwd_occs`` and ``flow_fwd``. ``src`` is the neighbour's frame; where
    the term compares against zero, ``src``, ``flow`` and ``slot`` are -1.
    ``slot`` is the warp's row in the cotangent scratch."""
    frame: int
    kind: int
    occ: int
    src: int
    flow: int
    slot: int


@functools.cache
def guidance_terms(num_frames: int, mode: str) -> Tuple[Term, ...]:
    """The loss's terms in (frame, kind) order, warps numbered in that order.

    ``reference``: the backward term of frame k (k <= t-2) warps frame k+1
    by ``flow_bwd[k+1]`` if k+1 <= t-2, else compares against zero; the
    forward term of frame k (k >= 1) warps frame k-1 by ``flow_fwd[k-2]`` if
    k-1 >= 1, else zero. ``aligned``: frame k+1 by ``flow_bwd[k]`` and frame
    k-1 by ``flow_fwd[k-1]``."""
    if mode not in MODES:
        raise ValueError(f"unknown temporal loss mode {mode!r}")
    t = num_frames
    terms, slot = [], 0
    for k in range(t):
        for kind, on in ((0, k <= t - 2), (1, k >= 1)):
            if not on:
                continue
            if kind == 0:
                occ = k
                src, flow = (k + 1, k + 1 if mode == "reference" else k)
                if mode == "reference" and k + 1 > t - 2:
                    src = flow = -1
            else:
                occ = k - 1
                src, flow = (k - 1, k - 2 if mode == "reference" else k - 1)
                if mode == "reference" and k - 1 < 1:
                    src = flow = -1
            terms.append(Term(k, kind, occ, src, flow, slot if src >= 0 else -1))
            slot += src >= 0
    return tuple(terms)


@functools.cache
def warp_slots(num_frames: int, mode: str) -> int:
    """Warps of one window: 2(t-2) in ``reference`` mode, 2(t-1) in ``aligned``."""
    return sum(term.slot >= 0 for term in guidance_terms(num_frames, mode))


@functools.cache
def _kernel_table(num_frames: int, mode: str) -> ctypes.Array:
    """The term table as ``csrc/guidance.cu``'s GuidanceTable lays it out:
    per frame and kind (occ, src, flow, slot), -1 where there is no term; per
    slot (src, kind, flow)."""
    term = [[[-1] * 4 for _ in range(2)] for _ in range(MAX_FRAMES)]
    warp = [[0] * 3 for _ in range(2 * MAX_FRAMES)]
    for tm in guidance_terms(num_frames, mode):
        term[tm.frame][tm.kind] = [tm.occ, tm.src, tm.flow, tm.slot]
        if tm.slot >= 0:
            warp[tm.slot] = [tm.src, tm.kind, tm.flow]
    flat = [v for per_frame in term for entry in per_frame for v in entry]
    flat += [v for entry in warp for v in entry]
    return (ctypes.c_int * len(flat))(*flat)


@functools.cache
def _inv_n(n: int) -> float:
    """1/N in float32, as autograd's mean backward computes it."""
    return float(torch.ones((), dtype=torch.float32) / n)


def _window(latents: torch.Tensor, num_frames: int):
    bt, h, w, c = latents.shape
    return bt // num_frames, h, w, c


def guidance_residual_plain(latents: torch.Tensor, flows: Pair, occs: Pair, num_frames: int,
                            mode: str = "reference") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of launch A, term by term as the kernel loops:
    (gradient holding each frame's direct part, cotangent scratch
    [b, slots, h, w, c])."""
    terms = guidance_terms(num_frames, mode)
    b, h, w, c = _window(latents, num_frames)
    lat = latents.reshape(b, num_frames, h, w, c)
    inv_n = _inv_n(b * h * w * c)
    grad = torch.zeros_like(lat)
    cot = torch.empty((b, warp_slots(num_frames, mode), h, w, c), dtype=latents.dtype,
                      device=latents.device)
    zero = torch.zeros_like(lat[:, 0])
    for tm in terms:
        m = 1.0 - occs[tm.kind][:, tm.occ]
        prev = zero if tm.src < 0 else warp_plain(lat[:, tm.src], flows[1 - tm.kind][:, tm.flow])
        ct = inv_n * torch.sgn(m * prev - m * lat[:, tm.frame]) * m
        grad[:, tm.frame] -= ct
        if tm.slot >= 0:
            cot[:, tm.slot] = ct
    return grad.reshape(latents.shape), cot


def guidance_scatter_plain(grad: torch.Tensor, cot: torch.Tensor, flows: Pair, num_frames: int,
                           mode: str = "reference") -> torch.Tensor:
    """Plain version of launch B: adds each warp's transpose of its cotangent
    into the gradient of its source frame, in place; returns ``grad``."""
    b, h, w, c = _window(grad, num_frames)
    per_frame = grad.view(b, num_frames, h, w, c)
    for tm in guidance_terms(num_frames, mode):
        if tm.slot >= 0:
            per_frame[:, tm.src] += warp_dx_plain(cot[:, tm.slot], flows[1 - tm.kind][:, tm.flow])
    return grad


def guidance_grad_plain(latents: torch.Tensor, flows: Pair, occs: Pair, num_frames: int,
                        mode: str = "reference") -> torch.Tensor:
    """d temporal_warp_loss / d latents by autograd through the plain warp;
    zero for a single frame, which has no terms."""
    guidance_terms(num_frames, mode)  # checks the mode
    if num_frames <= 1:
        return torch.zeros_like(latents)
    with torch.enable_grad():
        lat = latents.detach().requires_grad_(True)
        loss = temporal_warp_loss(lat, flows, occs, num_frames, mode, warp=warp_plain)
        (grad,) = torch.autograd.grad(loss, lat)
    return grad


def _check(name: str, tensors, shapes) -> None:
    """float32 on the first one's CUDA device, none asking autograd for a
    gradient; each with a shape given is contiguous and of that shape.
    (``get_device`` and ``is_cuda``: a ``.device`` costs a microsecond of
    host time a read.)"""
    index = tensors[0].get_device()
    for z, shape in zip(tensors, shapes):
        if z.dtype is not torch.float32:
            raise TypeError(f"{name}: float32 tensors only, got {z.dtype}")
        if not z.is_cuda or z.get_device() != index:
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got "
                             f"{z.device} and {tensors[0].device}")
        if shape is not None and (z.shape != shape or not z.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous tensor of shape {shape}, got "
                             f"{tuple(z.shape)} with strides {z.stride()}")
        if z.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{name}: the CUDA kernels compute a gradient but have none "
                               f"of their own; call it on tensors that do not require grad")


def _frames_geometry(name: str, frames: torch.Tensor, num_frames: int, mode: str):
    """(b, h, w, c) of [b*t, h, w, c] latents or gradient. Every tensor the
    kernels index, the cotangent scratch and the flows included, must stay
    under 2^31 elements: the kernels' offsets are 32-bit."""
    guidance_terms(num_frames, mode)  # checks the mode
    if frames.ndim != 4 or not 1 <= num_frames <= MAX_FRAMES or frames.shape[0] % num_frames:
        raise ValueError(f"{name}: need [b*t, h, w, c] with 1 <= t = {num_frames} <= "
                         f"{MAX_FRAMES} dividing the first dimension, got {tuple(frames.shape)}")
    b, h, w, c = _window(frames, num_frames)
    pixels = b * h * w
    largest = max(frames.numel(), pixels * warp_slots(num_frames, mode) * c,
                  pixels * (num_frames - 1) * 2)
    if largest >= 2 ** 31:
        raise ValueError(f"{name}: a tensor of {largest} elements (latents, cotangent scratch "
                         f"or flows); the kernels index in 32 bits")
    return b, h, w, c


def _layout(name: str, frames: torch.Tensor) -> None:
    """The kernels read the latents and write the gradient and the scratch
    through one set of strides: dense (a permutation of a contiguous tensor)
    with frames outermost."""
    _, h, w, c = frames.shape
    step = 1
    dense = frames.stride(0) == h * w * c
    for size, stride in sorted(zip(frames.shape[1:], frames.stride()[1:]), key=lambda p: p[1]):
        dense &= size == 1 or stride == step
        step *= size
    if not dense:
        raise ValueError(f"{name}: need a dense tensor with frames outermost (a permutation "
                         f"of a contiguous one), got strides {frames.stride()}")


def _scratch_strides(frames: torch.Tensor, slots: int):
    """The cotangent scratch's strides: [b, slots, h, w, c], each slot laid
    out as a frame of the latents (planar where they are)."""
    frame, row, col, chan = frames.stride()
    return slots * frame, frame, row, col, chan


def _check_inputs(name, latents, flows, occs, num_frames, mode):
    b, h, w, c = _frames_geometry(name, latents, num_frames, mode)
    pair = (b, num_frames - 1, h, w)
    _check(name, (latents, *flows, *occs), (None, (*pair, 2), (*pair, 2), (*pair, 1), (*pair, 1)))
    _layout(name, latents)
    return b, h, w, c


def _launch_residual(latents, flows, occs, num_frames, mode, stream, b, h, w, c):
    slots = warp_slots(num_frames, mode)
    grad = torch.empty_like(latents)
    cot = torch.empty_strided((b, slots, h, w, c), _scratch_strides(latents, slots),
                              dtype=latents.dtype, device=latents.device)
    err = _build.library().mgld_guidance_residual_f32(
        latents.data_ptr(), flows[0].data_ptr(), flows[1].data_ptr(), occs[0].data_ptr(),
        occs[1].data_ptr(), grad.data_ptr(), cot.data_ptr(), _kernel_table(num_frames, mode),
        *latents.stride(), b, num_frames, h, w, c, slots, _inv_n(b * h * w * c), stream)
    _build.check(err, "mgld_guidance_residual_f32")
    guidance_residual.launches += 1
    return grad, cot


def _fixed_scale(n: int) -> float:
    """Launch B's fixed point: the power of two that puts 1/N in [2^31,
    2^32), so a sum of cotangents of |m| <= 1 stays far inside 64 bits."""
    return math.ldexp(1.0, 32 - math.frexp(_inv_n(n))[1])


def _launch_scatter(grad, cot, flows, num_frames, mode, stream, b, h, w, c):
    slots = warp_slots(num_frames, mode)
    if slots == 0:
        return grad
    acc = torch.zeros_like(grad, dtype=torch.int64)  # grad's strides
    err = _build.library().mgld_guidance_scatter_f32(
        flows[0].data_ptr(), flows[1].data_ptr(), cot.data_ptr(), grad.data_ptr(),
        acc.data_ptr(), _kernel_table(num_frames, mode), *grad.stride(), b, num_frames, h, w, c,
        slots, _fixed_scale(b * h * w * c), stream)
    _build.check(err, "mgld_guidance_scatter_f32")
    guidance_scatter.launches += 1
    return grad


def guidance_residual(latents: torch.Tensor, flows: Pair, occs: Pair, num_frames: int,
                      mode: str = "reference") -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch A: (gradient holding each frame's direct part, in the latents'
    layout; cotangent scratch [b, slots, h, w, c], each slot in that layout
    too) for latents [b*t, h, w, c] (dense, frames outermost), contiguous
    flows (forward, backward) [b, t-1, h, w, 2] and occlusions (fwd, bwd)
    [b, t-1, h, w, 1]."""
    if latents.is_cpu:
        return guidance_residual_plain(latents, flows, occs, num_frames, mode)
    geometry = _check_inputs("guidance_residual", latents, flows, occs, num_frames, mode)
    return _launch_residual(latents, flows, occs, num_frames, mode,
                            _build.stream_ptr(latents.device), *geometry)


def guidance_scatter(grad: torch.Tensor, cot: torch.Tensor, flows: Pair, num_frames: int,
                     mode: str = "reference") -> torch.Tensor:
    """Launch B: adds the transpose of every warp of the cotangent scratch
    (laid out as :func:`guidance_residual` returns it) into ``grad`` [b*t, h,
    w, c] in place, and returns it. No launch where the loss has no warps
    (``reference`` mode at t <= 2)."""
    if grad.is_cpu:
        return guidance_scatter_plain(grad, cot, flows, num_frames, mode)
    b, h, w, c = _frames_geometry("guidance_scatter", grad, num_frames, mode)
    pair = (b, num_frames - 1, h, w, 2)
    _check("guidance_scatter", (grad, cot, *flows), (None, None, pair, pair))
    _layout("guidance_scatter", grad)
    slots = warp_slots(num_frames, mode)
    strides = _scratch_strides(grad, slots)
    if cot.shape != (b, slots, h, w, c) or cot.stride() != strides:
        raise ValueError(f"guidance_scatter: need the scratch of shape {(b, slots, h, w, c)} "
                         f"and strides {strides}, as guidance_residual makes it; got "
                         f"{tuple(cot.shape)} with strides {cot.stride()}")
    return _launch_scatter(grad, cot, flows, num_frames, mode, _build.stream_ptr(grad.device),
                           b, h, w, c)


guidance_residual.launches = 0
guidance_scatter.launches = 0


def guidance_grad(latents: torch.Tensor, flows: Pair, occs: Pair, num_frames: int,
                  mode: str = "reference") -> torch.Tensor:
    """d temporal_warp_loss(latents, flows, occs, num_frames, mode) / d
    latents, a plain function of its inputs: launch A, the accumulator's
    zero fill, launch B and its finishing kernel on the card (no autograd),
    :func:`guidance_grad_plain` on the CPU."""
    if latents.is_cpu:
        return guidance_grad_plain(latents, flows, occs, num_frames, mode)
    geometry = _check_inputs("guidance_grad", latents, flows, occs, num_frames, mode)
    stream = _build.stream_ptr(latents.device)
    grad, cot = _launch_residual(latents, flows, occs, num_frames, mode, stream, *geometry)
    return _launch_scatter(grad, cot, flows, num_frames, mode, stream, *geometry)

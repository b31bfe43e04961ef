#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's restore path once on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 50] [--seed 0]

Phase 0  refuse to run without CUDA; print the card's name and power limit.
Phase 1  build the CUDA kernels from csrc/ (nvcc, sm_90a) and load them.
Phase 2  hold each kernel (the seven that replace a TPU kernel, the
         statistics kernel of the fused chain, and the guidance pair that
         replaces the two warp kernels on the restore path) against its plain
         PyTorch version on the card at the main path's shapes; time both
         with CUDA events, time the one PyTorch library call that computes
         the same function where there is one, and compute the card's lower
         bound for the work. The kernels that take under 0.1 ms are also
         replayed from a CUDA graph, which gives their time on the device
         without the host's launch path (``device_ms``).
         The guidance pair also: both loss modes, two windows at t = 3 and
         t = 2, 3 channels, masks all 0 and all 1, taps all outside; its
         launches a step from a profiler trace against the autograd step it
         replaced (the warp kernels, a memset and the loss's elementwise
         launches).
         The fused GroupNorm also: every split of a slab among 1, 2, 4 or 8
         blocks, a slab too long for shared memory, slabs off the 16-byte
         boundary, and a constant input. The RAFT lookup also: one launch a
         call, ragged level maps and centres far outside them.
         Attention also: ragged N, large logits, the [B,N,H,D] strided entry
         bit for bit against the folded call, and which of its two kernels
         (tensor-core or FMA) each type and head dim takes.
         The fused GroupNorm+SiLU+conv also: shapes off its tiles, narrow
         frames, a clipped variance, the re-laid weight bit for bit, and its
         ``mma.sync`` kernel against its tensor-core kernel.
Phase 3  tiny config at 256x256, float32, 2 steps, deterministic: the same
         weights on the card (kernels) and on the CPU (plain versions) must
         give the same frames, once in the default configuration and once
         with MGLD_FUSED_GN_CONV=1. In both configurations also the tile
         protocol (``restore_video``) on a 13x11 clip (two 64px patches of
         nine 4-latent canvas tiles, one and two patches a group) and the
         latent protocol (``restore_with_latents``: frames and latents).
Phase 4  the default configuration at full width: 5 frames x4 to 512x512, 50
         guided steps, bf16 UNet / struct-cond / VAE / CLIP and float32 RAFT
         with seeded random weights, through
         ``MGLDVSRPipeline.restore_segment``; every kernel but the fused
         GroupNorm+SiLU+conv's two and the standalone warp's two must have
         been launched by that run, the guidance pair once each a step, and
         every gated attention call (14 per step) must have taken the
         tensor-core kernel. The guidance gradient on the clip's real flows
         and masks must be non-zero and equal its plain version. Then the
         latent protocol (``restore_with_latents``) on the same clip and
         weights: frames and latents at their shapes, every kernel of the
         default configuration launched.
Phase 5  the fused configuration (MGLD_FUSED_GN_CONV=1) at the same width,
         clip, seed and weights: every kernel but the channel sums (whose
         GroupNorms all head a fused chain) must have been launched,
         every chain as two launches (statistics, conv), and every bf16 chain
         with more than 8 output channels on the tensor-core kernel.

Phase 6  the tile protocol at full width (phase 4's weights) on a 5-frame
         180x320 clip restored to 720x1280: the device memory one more patch
         adds to a group (two steps, one and two patches a group, at both
         patch geometries); (a) the auto geometry (512/448 px, six patches)
         at --steps steps with the patch batch the envelope allows; (b) the
         reference geometry (960/750 px: two 736x960 patches of six canvas
         tiles) at 5 steps. Each must give finite frames in [0, 1], launch
         kernels 1-6, the guidance pair once a step a patch group, and
         nothing of the fused configuration. The bytes a patch adds must not
         exceed the pipeline's PATCH_BYTES_PER_PIXEL. (c) the largest group
         of 736x960 patches the envelope allows, in one group on a clip wide
         enough to fill it (past 2^32 elements in the VAE from 5 patches), at
         2 steps: its frames must match one patch a group within bf16's
         rounding.
Phase 7  the inference CLI on the card: a clip of 7 PNG frames of 32x48 (two
         windows, the last padded) through ``--preset tiny`` in fixed (two
         windows a call), tile and latent mode; every frame and latent must
         be written and read back at its shape. Then ``--preset full`` in
         fixed mode on five 128x128 frames (512x512 out, 3 steps): the
         frames written, every kernel of the default configuration launched.

Prints one JSON line describing the kernels before the last line, and the
result line ``{"ok": true, "device": {...}}`` last. Any failure raises and
exits non-zero without the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

KERNELS = {
    # wrapper name: (route, source, TPU kernel it replaces)
    "warp_forward": ("cuda", "mgldvsr_tpu_torch/csrc/flow_warp.cu",
                     "mgldvsr_tpu/ops/pallas/flow_warp.py:103"),
    "warp_dx": ("cuda", "mgldvsr_tpu_torch/csrc/flow_warp.cu",
                "mgldvsr_tpu/ops/pallas/flow_warp.py:203"),
    # on the restore path both warp kernels, and the loss around them, are these two
    "guidance_residual": ("cuda", "mgldvsr_tpu_torch/csrc/guidance.cu",
                          "mgldvsr_tpu/ops/pallas/flow_warp.py:103"),
    "guidance_scatter": ("cuda", "mgldvsr_tpu_torch/csrc/guidance.cu",
                         "mgldvsr_tpu/ops/pallas/flow_warp.py:203"),
    "attention": ("cuda", "mgldvsr_tpu_torch/csrc/attention.cu",
                  "mgldvsr_tpu/ops/pallas/attention.py:76"),
    "corr_lookup": ("cuda", "mgldvsr_tpu_torch/csrc/corr_lookup.cu",
                    "mgldvsr_tpu/ops/pallas/corr_lookup.py:94"),
    "channel_sums": ("triton", "mgldvsr_tpu_torch/ops/kernels/groupnorm.py",
                     "mgldvsr_tpu/ops/pallas/groupnorm.py:55"),
    "fused_group_norm": ("cuda", "mgldvsr_tpu_torch/csrc/groupnorm.cu",
                         "mgldvsr_tpu/ops/pallas/groupnorm.py:139"),
    "gn_silu_conv3x3": ("cuda", "mgldvsr_tpu_torch/csrc/gn_silu_conv.cu",
                        "mgldvsr_tpu/ops/pallas/gn_silu_conv.py:154"),
    # the statistics of the same TPU function, which it left to XLA
    "gn_scale_shift": ("cuda", "mgldvsr_tpu_torch/csrc/gn_silu_conv.cu",
                       "mgldvsr_tpu/ops/pallas/gn_silu_conv.py:161"),
}
FUSED_ONLY = ("gn_silu_conv3x3", "gn_scale_shift")  # launched by the fused configuration alone
# launched by the default configuration alone: its GroupNorms of 128^2 pixels
# and more all head a chain, which the fused configuration gives to the two above
DEFAULT_ONLY = ("channel_sums",)
# held in phase 2 alone: the restore's guidance step runs the guidance pair
STANDALONE = ("warp_forward", "warp_dx")

# NVIDIA H100 SXM data sheet, dense: device memory bytes/s, tensor-core
# flop/s for bf16 and fp16, fp32 flop/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12}


def bound(nbytes: float, flops: float, kind: str):
    """(least ms the card could take, what binds it): the larger of bytes
    over the memory rate and operations over the peak rate of ``kind``."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[kind]
    return 1000 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@contextlib.contextmanager
def fused_switch(on: bool):
    """Set MGLD_FUSED_GN_CONV for the enclosed calls (it is read at call
    time) and restore the previous value."""
    before = os.environ.get("MGLD_FUSED_GN_CONV")
    os.environ["MGLD_FUSED_GN_CONV"] = "1" if on else "0"
    try:
        yield
    finally:
        if before is None:
            del os.environ["MGLD_FUSED_GN_CONV"]
        else:
            os.environ["MGLD_FUSED_GN_CONV"] = before


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of one ``fn()``: ``iters`` calls are captured into one
    CUDA graph and the graph is replayed, so the host's launch path is not in
    the time."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds one ``fn()`` takes to return (checks, allocation and
    the launch's enqueue), the device's work not waited for."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * elapsed / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def device_activity(fn, calls: int = 10) -> tuple[float, float]:
    """(device activities a warm ``fn()``: kernels, memsets and copies; their
    summed device ms a call), from a ``torch.profiler`` CUDA trace of
    ``calls`` calls. The trace can miss the window's first activity, so one
    call alone may read one launch short."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in events) / calls,
            sum(e.self_device_time_total for e in events) / 1000 / calls)


def bf16_ulps(count: int, want) -> float:
    """``count`` bfloat16 ulps at max |want|: a limit that follows the data."""
    return count * 2 ** -8 * float(want.float().abs().max())


def attention_inputs(bh: int, n: int, d: int, dtype, dev, gen):
    """q, k ~ N(0,1) and v ~ N(1,1). With a zero-mean v the outputs would be
    averages of N values around 0, std sqrt(e/N), a few 1e-2, and a limit
    that catches a dropped key tile or a wrong mask would sit in the rounding
    noise; with mean 1 the outputs are O(1) and such a fault moves them by
    several percent."""
    import torch

    q, k, v = (torch.randn(bh, n, d, device=dev, generator=gen) for _ in range(3))
    return q.to(dtype), k.to(dtype), (v + 1).to(dtype)


def lq_clip(seed: int, size: int, frames: int = 5, width: int | None = None) -> np.ndarray:
    """[T, size, width (default size), 3] in [0,1]: a smooth seeded pattern
    moving 2 px right and 1 px down per frame, so that flows are non-zero."""
    rs = np.random.RandomState(seed)
    width = size if width is None else width
    big_h, big_w = size + 4 * frames, width + 4 * frames
    yy, xx = np.mgrid[0:big_h, 0:big_w].astype(np.float32) / max(big_h, big_w)
    pattern = np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * (rs.uniform(1, 4) * xx + rs.uniform(1, 4) * yy
                                        + rs.uniform(0, 1)))
        for _ in range(3)], axis=-1)
    pattern += 0.05 * rs.rand(big_h, big_w, 3).astype(np.float32)
    clip = [pattern[f:f + size, 2 * f:2 * f + width] for f in range(frames)]
    return np.clip(np.stack(clip), 0.0, 1.0).astype(np.float32)


def calm_raft(pipe) -> None:
    """Scale RAFT's last flow-head conv by 1e-2. Random RAFT weights predict
    flows of several latent pixels that disagree between the two
    directions, so the consistency check marks every pixel occluded and the
    guidance gradient is exactly zero. Small flows stay under its 0.5 px
    threshold, so the guidance acts on the run as it would with trained
    weights."""
    import torch

    with torch.no_grad():
        pipe.raft.update_block.flow_head.conv2.weight.mul_(1e-2)


def guidance_inputs(b: int, t: int, c: int, case: str, dev, gen, h: int = 64, w: int = 64):
    """latents [b*t,h,w,c] ~ N(0,1) as NHWC views of NCHW memory, the layout
    the sampler holds them in (``packed``: contiguous NHWC), flows (forward,
    backward) [b,t-1,h,w,2] of about 2 px (or w + 2.5 everywhere: every tap
    outside), occlusions [b,t-1,h,w,1] at 30% (or none, or all)."""
    import torch

    if case == "packed":
        lat = torch.randn(b * t, h, w, c, device=dev, generator=gen)
    else:
        lat = torch.randn(b * t, c, h, w, device=dev, generator=gen).permute(0, 2, 3, 1)
    if case == "taps outside":
        flows = tuple(torch.full((b, t - 1, h, w, 2), w + 2.5, device=dev) for _ in range(2))
    else:
        flows = tuple(torch.randn(b, t - 1, h, w, 2, device=dev, generator=gen) * 2
                      for _ in range(2))
    share = {"all occluded": 1.0, "none occluded": 0.0}.get(case, 0.3)
    occs = tuple((torch.rand(b, t - 1, h, w, 1, device=dev, generator=gen) < share).float()
                 for _ in range(2))
    return lat, flows, occs


def small_residuals(lat, flows, occs, t: int, mode: str, eps: float = 1e-6) -> int:
    """Unmasked elements of the loss's terms whose residual |m prev - m lat|
    is under ``eps``: where a prev summed in another order could flip sgn."""
    from mgldvsr_tpu_torch.ops.kernels import guidance as guide_mod
    from mgldvsr_tpu_torch.ops.kernels.flow_warp import warp_plain

    lat5 = lat.reshape(lat.shape[0] // t, t, *lat.shape[1:])
    n = 0
    for tm in guide_mod.guidance_terms(t, mode):
        m = 1.0 - occs[tm.kind][:, tm.occ]
        prev = 0.0 if tm.src < 0 else warp_plain(lat5[:, tm.src], flows[1 - tm.kind][:, tm.flow])
        r = m * prev - m * lat5[:, tm.frame]
        n += int(((r.abs() < eps) & (m != 0)).sum())
    return n


def guidance_bytes(b: int, t: int, h: int, w: int, c: int, mode: str) -> dict:
    """Bytes float32 launches A and B and the whole gradient must move, from
    the term table: the latent frames the terms read, the mask slices they
    read, the flow slices their warps read, the gradient written; A also
    writes the cotangent scratch, which B reads, and B reads and writes the
    gradient of the warps' source frames alone."""
    from mgldvsr_tpu_torch.ops.kernels import guidance as guide_mod

    terms = guide_mod.guidance_terms(t, mode)
    warps = [tm for tm in terms if tm.slot >= 0]
    frame, pixels = 4 * b * h * w * c, b * h * w
    frames_read = len({tm.frame for tm in terms} | {tm.src for tm in warps})
    masks = 4 * pixels * len({(tm.kind, tm.occ) for tm in terms})
    flows = 8 * pixels * len({(tm.kind, tm.flow) for tm in warps})
    cot = frame * len(warps)
    pair = frame * frames_read + masks + flows + frame * t
    return {"A": pair + cot, "B": cot + flows + 2 * frame * len({tm.src for tm in warps}),
            "pair": pair}


def guidance_phase2(dev, gen, card: str, record) -> dict:
    """The guidance pair against its plain versions in every case, then timed
    at the restore's shape beside the autograd step it replaced."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.kernels import guidance as guide_mod

    worst = 0.0  # the direct part's and the cotangent's error over the cases
    for b, t, c, case in ((1, 5, 4, "random"), (1, 5, 4, "packed"), (2, 3, 4, "random"),
                          (2, 2, 4, "random"), (1, 5, 3, "random"), (1, 5, 3, "packed"),
                          (1, 5, 4, "none occluded"), (1, 5, 4, "all occluded"),
                          (1, 5, 4, "taps outside")):
        for mode in ("reference", "aligned"):
            lat, flows, occs = guidance_inputs(b, t, c, case, dev, gen)
            kernels.reset_launch_counts()
            grad, cot = guide_mod.guidance_residual(lat, flows, occs, t, mode)
            direct, want_cot = guide_mod.guidance_residual_plain(lat, flows, occs, t, mode)
            err_a = max(max_err(grad, direct), max_err(cot, want_cot) if cot.numel() else 0.0)
            got = guide_mod.guidance_scatter(grad, cot, flows, t, mode)
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            want = guide_mod.guidance_grad_plain(lat, flows, occs, t, mode)
            err, tol = max_err(got, want), 1e-6 * float(want.abs().max())
            log(f"[phase2] guidance pair b={b} t={t} [64,64,{c}] {mode}, {case}: direct part and "
                f"cotangent max_abs_err {err_a:.3e} (limit 0: bit for bit), gradient "
                f"{err:.3e} (limit {tol:.3e}), residuals under 1e-6 "
                f"{small_residuals(lat, flows, occs, t, mode)}, launches {counts}")
            slots = guide_mod.warp_slots(t, mode)
            if not (err_a == 0.0 and err <= tol and torch.isfinite(got).all()):
                raise AssertionError(f"guidance pair b={b} t={t} c={c} {mode} {case}: "
                                     f"{err_a:.3e} > 0 or {err:.3e} > {tol:.3e}")
            if counts != {"guidance_residual": 1, **({"guidance_scatter": 1} if slots else {})}:
                raise AssertionError(f"guidance pair: launches {counts}, slots {slots}")
            if bool(want.any()) != (case != "all occluded"):
                raise AssertionError(f"guidance pair {case}: the gradient is zero or not zero")
            worst = max(worst, err_a)

    # timed at the restore's call: one window of 5 frames, reference mode
    lat, flows, occs = guidance_inputs(1, 5, 4, "random", dev, gen)
    grad, cot = guide_mod.guidance_residual(lat, flows, occs, 5)
    want = guide_mod.guidance_grad_plain(lat, flows, occs, 5)
    shape = "b=1, t=5, [64,64,4] f32 (NCHW memory, as the sampler holds it), reference"
    moved = guidance_bytes(1, 5, 64, 64, 4, "reference")
    record("guidance_residual", worst, 0.0,
           cuda_ms(lambda: guide_mod.guidance_residual(lat, flows, occs, 5)),
           cuda_ms(lambda: guide_mod.guidance_residual_plain(lat, flows, occs, 5)),
           shape + " (error: the worst of the 18 cases)",
           *bound(moved["A"], 40.0 * lat.numel() * 2, "f32"),
           device_ms=graph_ms(lambda: guide_mod.guidance_residual(lat, flows, occs, 5)))
    scratch = grad.clone()
    got = guide_mod.guidance_scatter(grad.clone(), cot, flows, 5)
    record("guidance_scatter", max_err(got, want), 1e-6 * float(want.abs().max()),
           cuda_ms(lambda: guide_mod.guidance_scatter(scratch, cot, flows, 5)),
           cuda_ms(lambda: guide_mod.guidance_scatter_plain(scratch, cot, flows, 5)),
           shape + " (the pair's gradient vs guidance_grad_plain)",
           *bound(moved["B"], 16.0 * cot.numel(), "f32"),
           device_ms=graph_ms(lambda: guide_mod.guidance_scatter(scratch, cot, flows, 5)))

    def pair():
        return guide_mod.guidance_grad(lat, flows, occs, 5)

    def autograd_step():
        """What the sampler ran per step before the pair: the loss through
        kernels 1 and 2, then torch.autograd.grad."""
        with torch.enable_grad():
            leaf = lat.detach().requires_grad_(True)
            loss = guide_mod.temporal_warp_loss(leaf, flows, occs, 5)
            return torch.autograd.grad(loss, leaf)[0]

    kernels.reset_launch_counts()
    old = autograd_step()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    err_old, tol = max_err(old, pair()), 1e-6 * float(want.abs().max())
    if counts != {"warp_forward": 1, "warp_dx": 1} or not err_old <= tol:
        raise AssertionError(f"guidance: the autograd step launched {counts}, differs by "
                             f"{err_old:.3e} (limit {tol:.3e})")
    n_old, dev_old = device_activity(autograd_step)
    n_new, dev_new = device_activity(pair)
    if round(n_new) != 2:
        raise AssertionError(f"guidance: the pair made {n_new} device launches a call, "
                             f"expected 2")
    out = {
        "shape": shape, "ms": cuda_ms(pair), "device_ms": graph_ms(pair),
        "host_us": host_us(pair), "launches": n_new, "device_activity_ms": dev_new,
        "autograd_step_ms": cuda_ms(autograd_step), "autograd_step_launches": n_old,
        "autograd_step_device_activity_ms": dev_old,
        "plain_ms": cuda_ms(lambda: guide_mod.guidance_grad_plain(lat, flows, occs, 5)),
        "bound_ms": bound(moved["pair"], 40.0 * lat.numel() * 2, "f32")[0],
        "max_abs_err_vs_autograd_step": err_old}
    log(f"[phase2] guidance gradient, {shape}: the pair {out['ms']:.4f} ms a call in a host "
        f"loop (on the device {out['device_ms']:.4f} ms, {out['host_us']:.1f} us to return), "
        f"{n_new:g} device launches a call ({dev_new:.4f} ms of device time); the autograd "
        f"step it replaced {out['autograd_step_ms']:.4f} ms, {n_old:g} device launches "
        f"({dev_old:.4f} ms); plain version {out['plain_ms']:.4f} ms; bound "
        f"{out['bound_ms']:.4f} ms (bytes: {moved['pair']} B; launch A {moved['A']} B, B "
        f"{moved['B']} B); pair vs autograd step max_abs_err {err_old:.3e}  [{card}]")
    return out


def attention_checks(dev, gen) -> None:
    """The attention kernels off the timed shapes: ragged N, large logits,
    the strided entry, and the dispatch between the two kernels."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.kernels import attention as attn_mod

    bf16 = torch.bfloat16

    def check(what, got, want, tol, want_counts):
        err = max_err(got, want)
        counts = {name: n for name, n in kernels.launch_counts().items() if "attention" in name}
        log(f"[phase2] attention {what}: max_abs_err {err:.3e} (limit {tol:.3e}), {counts}")
        if not err <= tol or not torch.isfinite(got).all():
            raise AssertionError(f"attention {what}: {err:.3e} > {tol:.3e}")
        if counts != want_counts:
            raise AssertionError(f"attention {what}: launches {counts}, expected {want_counts}")

    def qkv(bh, n, d, dtype):
        return attention_inputs(bh, n, d, dtype, dev, gen)

    def counts(wgmma: int, strided: int):
        return {"attention": 1, "attention_wgmma": wgmma, "attention_strided": strided}

    # N off the 128-row tiles: masked keys, unwritten query rows. Held against
    # the plain version in bf16 and in float32 on the same bf16 values.
    q, k, v = qkv(8, 1100, 64, bf16)
    for name, want in (("bf16", attn_mod.attention_plain(q, k, v)),
                       ("f32", attn_mod.attention_plain(q.float(), k.float(), v.float()))):
        kernels.reset_launch_counts()
        check(f"ragged [8,1100,64] bf16 vs the plain version in {name}",
              attn_mod.attention(q, k, v), want, bf16_ulps(3, want), counts(1, 1))
    # logits of tens (q scaled by 8): the running max moves and the accumulator
    # is rescaled from tile to tile. The plain version in bf16 rounds its
    # logits to bf16 (a relative 2^-9 of ~60 is several percent of a
    # probability), so the reference here is the plain version in float32 on
    # the same bf16 values; the kernel's own rounding of P to bf16 stays
    # within the same 2e-2.
    q, k, v = qkv(8, 1100, 64, bf16)
    q = q * 8
    kernels.reset_launch_counts()
    check("large logits [8,1100,64] bf16 vs the plain version in f32",
          attn_mod.attention(q, k, v), attn_mod.attention_plain(q.float(), k.float(), v.float()),
          2e-2, counts(1, 1))
    # the same heads through [B,N,H,D] strides, as the UNet's CrossAttention
    # hands them over: bit for bit the folded call, no copy made
    for b, n, h in ((5, 4096, 5), (5, 1024, 10)):
        q, k, v = (z.reshape(b, n, h, 64) for z in qkv(b, n, h * 64, bf16))
        folded = attn_mod.attention(*(z.permute(0, 2, 1, 3).reshape(b * h, n, 64).contiguous()
                                      for z in (q, k, v)))
        kernels.reset_launch_counts()
        got = attn_mod.attention_bnhd(q, k, v)
        check(f"strided [{b},{n},{h},64] bf16 vs the folded call, bit for bit", got,
              folded.reshape(b, h, n, 64).permute(0, 2, 1, 3), 0.0, counts(1, 1))
        if not got.is_contiguous():
            raise AssertionError("attention: the strided entry's output is not contiguous")
    # a [B,N,H,D] operand that is contiguous but whose base is 2 bytes off a
    # 16-byte boundary cannot be read in place: it is copied, not faulted on
    flat = [z.reshape(-1) for z in qkv(10, 1025, 64, bf16)]
    q, k, v = (z[1:1 + 2 * 1024 * 5 * 64].view(2, 1024, 5, 64) for z in flat)
    if not (q.is_contiguous() and q.data_ptr() % 16 == 2):
        raise AssertionError("attention: the misaligned operand is not what it should be")
    want = attn_mod.attention_bnhd(q.clone(), k.clone(), v.clone())
    kernels.reset_launch_counts()
    check("[2,1024,5,64] bf16 with bases 2 bytes off 16 vs aligned copies, bit for bit",
          attn_mod.attention_bnhd(q, k, v), want, 0.0, counts(1, 0))
    # float32 (the parity mode) and bf16 at head dim 16 take the FMA kernel,
    # whose probabilities stay in float32
    for d, dtype in ((64, torch.float32), (16, bf16)):
        q, k, v = qkv(8, 1024, d, dtype)
        want = attn_mod.attention_plain(q.float(), k.float(), v.float())
        kernels.reset_launch_counts()
        check(f"[8,1024,{d}] {'bf16' if dtype == bf16 else 'f32'} vs the plain version in f32",
              attn_mod.attention(q, k, v), want, bf16_ulps(3, want) if dtype == bf16 else 1e-4,
              counts(0, 0))


def group_norm_case(shape, dtype, dev, gen):
    import torch

    x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5).to(dtype)
    return (x, torch.randn(shape[1], device=dev, generator=gen),
            torch.randn(shape[1], device=dev, generator=gen))


def group_norm_limit(want) -> float:
    """2 ulps at max |y| in bf16 (a folded scale or shift that rounds to the
    neighbouring value), 1e-5 in float32 (sums in another order)."""
    import torch

    return 1e-5 + (bf16_ulps(2, want) if want.dtype == torch.bfloat16 else 0.0)


def group_norm_checks(dev, gen) -> None:
    """The fused GroupNorm off the timed shapes: each split of a slab among
    the blocks of a cluster, staged in shared memory and walked twice, slabs
    off the 16-byte boundary, channels that end inside a vector, a constant."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.kernels import groupnorm as gn_mod

    bf16, f32 = torch.bfloat16, torch.float32

    def check(what, got, want, tol):
        err = max_err(got, want)
        log(f"[phase2] fused_group_norm {what}: max_abs_err {err:.3e} (limit {tol:.3e})")
        if not err <= tol or not torch.isfinite(got).all():
            raise AssertionError(f"fused_group_norm {what}: {err:.3e} > {tol:.3e}")

    for shp, dtype, plan, what in (
            ((5, 1280, 8, 8), bf16, (1, 5120), "one block a slab"),
            ((5, 1280, 16, 16), bf16, (2, 10240), "a cluster of 2"),
            ((5, 640, 32, 32), bf16, (4, 10240), "a cluster of 4"),
            ((2, 960, 64, 64), bf16, (8, 30720), "a cluster of 8"),
            ((1, 64, 300, 300), bf16, (8, 45008), "staged shares, the last one shorter"),
            ((1, 1280, 5, 64, 64), f32, (8, 0), "shares of 400 KB, walked twice"),
            ((3, 64, 7, 9), bf16, (1, 256), "slabs of 252 bytes, bases off 16, odd channels"),
            ((1, 96, 37, 37), bf16, (1, 8224), "a ragged end under one vector"),
            ((2, 32, 3, 1), bf16, (1, 16), "channels shorter than a vector")):
        x, w, b = group_norm_case(shp, dtype, dev, gen)
        slabs, cg = shp[0] * 32, shp[1] // 32
        got_plan = gn_mod.fused_gn_plan(slabs, x[0].numel() // 32, x.element_size(), cg)
        if got_plan != plan:
            raise AssertionError(f"fused_group_norm {list(shp)}: plan {got_plan}, expected {plan}")
        kernels.reset_launch_counts()
        got = gn_mod.fused_group_norm(x, w, b, 32, 1e-5)
        if {k: v for k, v in kernels.launch_counts().items() if v} != {"fused_group_norm": 1}:
            raise AssertionError("fused_group_norm: a call is not one launch")
        want = gn_mod.fused_group_norm_plain(x, w, b, 32, 1e-5)
        check(f"{list(shp)} {'bf16' if dtype == bf16 else 'f32'} (split, staged bytes) = {plan}: "
              f"{what}", got, want, group_norm_limit(want))
        del x, got, want
    # a contiguous view one element into its buffer: every slab base off 16 bytes
    flat = (torch.randn(2 * 64 * 16 * 16 + 1, device=dev, generator=gen) * 2 + 0.5).to(bf16)
    x = flat[1:].view(2, 64, 16, 16)
    w, b = (torch.randn(64, device=dev, generator=gen) for _ in range(2))
    if x.data_ptr() % 16 == 0:
        raise AssertionError("fused_group_norm: the misaligned view is not what it should be")
    want = gn_mod.fused_group_norm_plain(x, w, b, 32, 1e-5)
    check("[2,64,16,16] bf16, a view 2 bytes off 16", gn_mod.fused_group_norm(x, w, b, 32, 1e-5),
          want, group_norm_limit(want))
    # x = 2 everywhere: exact sums, variance 0, a = w / sqrt(eps), and y is
    # the bias up to the rounding of two numbers of the size of 2 a
    x = torch.full((2, 64, 16, 16), 2.0, device=dev, dtype=bf16)
    got = gn_mod.fused_group_norm(x, w, b, 32, 1e-5)
    size = 2 * 1e-5 ** -0.5 * float(w.abs().max())
    check("[2,64,16,16] bf16, a constant (variance clipped at 0; 2 ulps of max |2 a|)", got,
          gn_mod.fused_group_norm_plain(x, w, b, 32, 1e-5), 2 * 2 ** -8 * size)


def lookup_checks(dev, gen) -> None:
    """The RAFT lookup off the timed shape: ragged and empty level maps,
    centres outside the maps and thousands of pixels away, another radius."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.kernels import corr_lookup as corr_mod

    pyr = [torch.randn(2, 256, hl, wl, device=dev, generator=gen)
           for hl, wl in ((16, 16), (8, 8), (5, 3), (1, 7), (0, 0))]
    coords = torch.rand(2, 16, 16, 2, device=dev, generator=gen) * 30 - 8
    coords[0, 0, :3] = torch.tensor([[-3e4, 5.0], [5.0, 4e4], [1e9, -1e9]], device=dev)
    for radius in (4, 2):
        kernels.reset_launch_counts()
        got = corr_mod.lookup_corr(pyr, coords, radius)
        if kernels.launch_counts()["corr_lookup"] != 1:
            raise AssertionError("corr_lookup: a call is not one launch")
        err = max_err(got, corr_mod.lookup_corr_plain(pyr, coords, radius))
        log(f"[phase2] corr_lookup 5 levels [2,256,16x16, 8x8, 5x3, 1x7, 0x0], radius {radius}, "
            f"centres up to 1e9 px away: max_abs_err {err:.3e} (limit 1e-5)")
        if not err <= 1e-5 or got[0, 0, :3].any():
            raise AssertionError(f"corr_lookup: ragged levels, radius {radius}: {err:.3e}")


def phase2(card: str):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from mgldvsr_tpu_torch.flow.raft import build_corr_pyramid
    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.kernels import attention as attn_mod
    from mgldvsr_tpu_torch.ops.kernels import corr_lookup as corr_mod
    from mgldvsr_tpu_torch.ops.kernels import flow_warp as warp_mod
    from mgldvsr_tpu_torch.ops.kernels import gn_silu_conv as conv_mod
    from mgldvsr_tpu_torch.ops.kernels import groupnorm as gn_mod

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def record(name, err, tol, ms, plain_ms, shape, bound_ms, bound_by, library_ms=None,
               device_ms=None):
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        dev_txt = "" if device_ms is None else f" (on the device {device_ms:.4f} ms)"
        log(f"[phase2] {name} {shape}: max_abs_err {err:.3e} (limit {tol:.1e}) "
            f"kernel {ms:.4f} ms{dev_txt}, plain {plain_ms:.4f} ms, library {lib}, "
            f"bound {bound_ms:.4f} ms ({bound_by})  [{card}]")
        if not err <= tol:
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"({err:.3e} > {tol:.1e})")
        # the JSON line carries each kernel's first shape; max_abs_err its worst
        first = results.setdefault(name, {
            "shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "device_ms": device_ms})
        first["max_abs_err"] = max(first["max_abs_err"], err)

    # the standalone warp: 2(t-2) = 6 latents of one 5-frame window at
    # 64x64x4; 4 taps of 2 flops and ~12 flops of weights per output element.
    # The library call: F.grid_sample (bilinear, zeros, align_corners=True) of
    # the NCHW latents at the normalised p + flow, and its input gradient.
    x = torch.randn(6, 64, 64, 4, device=dev, generator=gen)
    flow = torch.randn(6, 64, 64, 2, device=dev, generator=gen) * 3
    g = torch.randn(6, 64, 64, 4, device=dev, generator=gen)
    shape = "x[6,64,64,4] f32"
    warp_bound = bound(nbytes(x, flow, x), 20 * x.numel(), "f32")
    gy, gx = torch.meshgrid(torch.arange(64.0, device=dev), torch.arange(64.0, device=dev),
                            indexing="ij")
    grid = torch.stack([(gx + flow[..., 0]) * (2 / 63) - 1, (gy + flow[..., 1]) * (2 / 63) - 1],
                       -1)
    xn, gn = (z.permute(0, 3, 1, 2).contiguous() for z in (x, g))

    def sample():
        return F.grid_sample(xn, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    def sample_dx():
        return torch.ops.aten.grid_sampler_2d_backward(gn, xn, grid, 0, 0, True, [True, False])

    log(f"[phase2]   F.grid_sample vs the plain warp: max_abs_err "
        f"{max_err(sample().permute(0, 2, 3, 1), warp_mod.warp_plain(x, flow)):.3e}; its "
        f"backward vs the plain dx "
        f"{max_err(sample_dx()[0].permute(0, 2, 3, 1), warp_mod.warp_dx_plain(g, flow)):.3e} "
        f"(another rounding of p + flow)")
    record("warp_forward", max_err(warp_mod.warp_forward(x, flow), warp_mod.warp_plain(x, flow)),
           1e-5, cuda_ms(lambda: warp_mod.warp_forward(x, flow)),
           cuda_ms(lambda: warp_mod.warp_plain(x, flow)), shape, *warp_bound, cuda_ms(sample),
           device_ms=graph_ms(lambda: warp_mod.warp_forward(x, flow)))
    xr = x.clone().requires_grad_(True)
    warp_mod.warp_plain(xr, flow).backward(g)
    dx = warp_mod.warp_dx(g, flow)
    err = max(max_err(dx, warp_mod.warp_dx_plain(g, flow)), max_err(dx, xr.grad))
    record("warp_dx", err, 1e-5, cuda_ms(lambda: warp_mod.warp_dx(g, flow)),
           cuda_ms(lambda: warp_mod.warp_dx_plain(g, flow)), shape + " (vs plain and autograd)",
           *warp_bound, cuda_ms(sample_dx), device_ms=graph_ms(lambda: warp_mod.warp_dx(g, flow)))
    del grid, xn, gn
    pair = guidance_phase2(dev, gen, card, record)
    results["guidance_residual"]["pair"] = results["guidance_scatter"]["pair"] = pair

    # attention: UNet self-attention at 64^2 (5 frames x 5 heads) and 32^2
    # (5 x 10), struct-cond at 64^2 (5 x 4), head dim 64, bf16: the
    # tensor-core kernel. Outputs are O(1) (attention_inputs) and the limit
    # is 3 bf16 ulps at max |want|, about 1e-2: the kernel and the plain
    # version each round the probabilities and the output to bf16 once. It
    # holds against the plain version on the same bf16 inputs and against the
    # plain version in float32 on the same values. 4 N^2 D flops per head.
    for bh, n in ((25, 4096), (50, 1024), (20, 4096)):
        q, k, v = attention_inputs(bh, n, 64, torch.bfloat16, dev, gen)
        kernels.reset_launch_counts()
        out = attn_mod.attention(q, k, v)
        if kernels.launch_counts()["attention_wgmma"] != 1:
            raise AssertionError("attention: bf16 at head dim 64 did not take the wgmma kernel")
        want32 = attn_mod.attention_plain(q.float(), k.float(), v.float())
        err32, tol = max_err(out, want32), bf16_ulps(3, want32)
        log(f"[phase2] attention [{bh},{n},64] bf16 vs the plain version in f32: max_abs_err "
            f"{err32:.3e} (limit {tol:.3e}), max |want| {float(want32.abs().max()):.3f}")
        if not err32 <= tol:
            raise AssertionError(f"attention: kernel disagrees with the plain version in f32 "
                                 f"({err32:.3e} > {tol:.3e})")
        del want32
        record("attention", max_err(out, attn_mod.attention_plain(q, k, v)), tol,
               cuda_ms(lambda: attn_mod.attention(q, k, v), iters=10),
               cuda_ms(lambda: attn_mod.attention_plain(q, k, v), iters=10),
               f"[{bh},{n},64] bf16", *bound(nbytes(q, k, v, out), 4.0 * bh * n * n * 64, "bf16"),
               cuda_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]),
                       iters=10))
        del q, k, v, out
    # one block to an SM against two (33 blocks of 128 rows a head at N = 4224):
    # what a partial last wave costs
    wave_ms = {}
    for bh in (4, 8):
        q, k, v = (torch.randn(bh, 4224, 64, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        wave_ms[bh] = cuda_ms(lambda: attn_mod.attention(q, k, v), iters=10)
    log(f"[phase2]   wgmma kernel [4,4224,64] (132 blocks, one to an SM) {wave_ms[4]:.4f} ms, "
        f"[8,4224,64] (264 blocks, two to an SM) {wave_ms[8]:.4f} ms = "
        f"{4e-9 * 8 * 4224 * 4224 * 64 / wave_ms[8]:.0f} TFLOP/s  [{card}]")
    results["attention"]["variant"] = ("wgmma (attention_wgmma_kernel) for bf16 at head dim 64; "
                                       "fma (attention_kernel) for f32 and other head dims")
    attention_checks(dev, gen)

    # RAFT lookup: 8 frame pairs, 64x64 queries at 1/8 of 512px, 4 levels, r=4.
    # Data-dependent reads: a query touches at most (2r+2)^2 cells of a level.
    f1 = torch.randn(8, 256, 64, 64, device=dev, generator=gen)
    f2 = torch.randn(8, 256, 64, 64, device=dev, generator=gen)
    pyr = [p.contiguous() for p in build_corr_pyramid(f1, f2, 4)]
    gy, gx = torch.meshgrid(torch.arange(64.0, device=dev), torch.arange(64.0, device=dev),
                            indexing="ij")
    coords = (torch.stack([gx, gy], -1)[None]
              + torch.randn(8, 64, 64, 2, device=dev, generator=gen) * 4).contiguous()
    kernels.reset_launch_counts()
    got = corr_mod.lookup_corr(pyr, coords, 4)
    if kernels.launch_counts()["corr_lookup"] != 1:
        raise AssertionError("corr_lookup: a call is not one launch")
    cells = sum(min(100, p.shape[-1] * p.shape[-2]) for p in pyr)
    # the library call: RAFT's own CorrBlock lookup, F.grid_sample of the
    # (2r+1)^2 window grid around each query at each level
    side = torch.arange(-4.0, 5.0, device=dev)
    delta = torch.stack(torch.meshgrid(side, side, indexing="ij"), -1)  # RAFT's (dy, dx) order
    maps, grids = [], []
    for lvl, p in enumerate(pyr):
        hl, wl = p.shape[-2:]
        at = coords.reshape(-1, 1, 1, 2) / 2 ** lvl + delta
        maps.append(p.reshape(-1, 1, hl, wl))
        grids.append(torch.stack([at[..., 0] * (2 / (wl - 1)) - 1, at[..., 1] * (2 / (hl - 1)) - 1],
                                 -1))

    def corr_block():
        return [F.grid_sample(m, gr, align_corners=True) for m, gr in zip(maps, grids)]

    lib_out = torch.cat([o.reshape(8, 4096, 81) for o in corr_block()], -1)
    log(f"[phase2]   RAFT's CorrBlock (F.grid_sample a level) vs the plain lookup: max_abs_err "
        f"{max_err(lib_out, corr_mod.lookup_corr_plain(pyr, coords, 4).reshape(8, 4096, -1)):.3e}")
    record("corr_lookup", max_err(got, corr_mod.lookup_corr_plain(pyr, coords, 4)),
           1e-4, cuda_ms(lambda: corr_mod.lookup_corr(pyr, coords, 4)),
           cuda_ms(lambda: corr_mod.lookup_corr_plain(pyr, coords, 4), iters=5),
           "pyramid [8,4096,64^2..8^2] f32, coords [8,64,64,2]",
           *bound(8 * 4096 * cells * 4 + nbytes(coords, got), 8.0 * got.numel(), "f32"),
           cuda_ms(corr_block), graph_ms(lambda: corr_mod.lookup_corr(pyr, coords, 4)))
    del maps, grids, lib_out
    log(f"[phase2]   the host's share of a call: "
        f"{host_us(lambda: corr_mod.lookup_corr(pyr, coords, 4)):.1f} us to return")
    lookup_checks(dev, gen)
    del f1, f2, pyr, got

    # GroupNorm sums: the VAE's 512^2 level, 5 frames x 128 channels, bf16;
    # float32 sums of 262144 terms: the limit is relative to the sums' size
    xb = torch.randn(5, 128, 512, 512, device=dev, generator=gen).to(torch.bfloat16) + 0.5
    t0 = time.perf_counter()
    s = gn_mod.channel_sums(xb)
    torch.cuda.synchronize()
    log(f"[phase2] channel_sums first call (Triton compile + run) "
        f"{time.perf_counter() - t0:.2f} s")
    p = gn_mod.channel_sums_plain(xb)
    err = max(max_err(s[0], p[0]), max_err(s[1], p[1]))
    record("channel_sums", err, 1e-5 * float(p[1].abs().max()),
           cuda_ms(lambda: gn_mod.channel_sums(xb)),
           cuda_ms(lambda: gn_mod.channel_sums_plain(xb)), "[5,128,512,512] bf16",
           *bound(nbytes(xb, *s), 3.0 * xb.numel(), "f32"),
           cuda_ms(lambda: torch.var_mean(xb, dim=(2, 3))),
           graph_ms(lambda: gn_mod.channel_sums(xb)))
    del xb, s, p

    # fused GroupNorm: the UNet's levels, the 960-channel skip concat (the
    # longest slab, 240 KB: a cluster of 8), a 5-D temporal input, and float32.
    # The folded scale and shift may round to the neighbouring bf16, so the
    # limit is 2 ulps at max |y|; float32 1e-5 (sums in another order).
    bf16, f32 = torch.bfloat16, torch.float32
    for shp, dtype, eps in (((5, 320, 64, 64), bf16, 1e-5), ((5, 960, 64, 64), bf16, 1e-5),
                            ((5, 1280, 8, 8), bf16, 1e-6), ((1, 1280, 5, 8, 8), bf16, 1e-5),
                            ((5, 32, 64, 64), f32, 1e-5), ((5, 32, 64, 64), f32, 1e-6)):
        x, w, b = group_norm_case(shp, dtype, dev, gen)
        got = gn_mod.fused_group_norm(x, w, b, 32, eps)
        want = gn_mod.fused_group_norm_plain(x, w, b, 32, eps)
        wd, bd = w.to(dtype), b.to(dtype)
        record("fused_group_norm", max_err(got, want), group_norm_limit(want),
               cuda_ms(lambda: gn_mod.fused_group_norm(x, w, b, 32, eps)),
               cuda_ms(lambda: gn_mod.fused_group_norm_plain(x, w, b, 32, eps)),
               f"{list(shp)} {'bf16' if dtype == bf16 else 'f32'} eps {eps:g}",
               *bound(nbytes(x, got, w, b), 8.0 * x.numel(), "f32"),
               cuda_ms(lambda: F.group_norm(x, 32, wd, bd, eps)),
               graph_ms(lambda: gn_mod.fused_group_norm(x, w, b, 32, eps)))
        log(f"[phase2]   the host's share of a call: "
            f"{host_us(lambda: gn_mod.fused_group_norm(x, w, b, 32, eps)):.1f} us to return, "
            f"F.group_norm {host_us(lambda: F.group_norm(x, 32, wd, bd, eps)):.1f} us")
        del x, got, want
    group_norm_checks(dev, gen)

    # the fused chain's statistics: the folded (scale, shift) of GroupNorm in
    # one launch, a cluster of blocks per (sample, group) slab; fp32 sums in
    # another order than the plain version's: 1e-5 of the largest value
    for shp, eps in (((5, 320, 64, 64), 1e-5), ((5, 960, 64, 64), 1e-5), ((5, 1280, 8, 8), 1e-6),
                     ((5, 128, 512, 512), 1e-6)):
        x = (torch.randn(shp, device=dev, generator=gen) * 2 + 0.5).to(bf16)
        w = torch.randn(shp[1], device=dev, generator=gen)
        b = torch.randn(shp[1], device=dev, generator=gen)

        def stats():
            return gn_mod.gn_scale_shift(x, w, b, 32, eps)

        got, want = stats(), gn_mod.gn_scale_shift_plain(x, w, b, 32, eps)
        err = max(max_err(a, p) / float(p.abs().max()) for a, p in zip(got, want))
        iters = 5 if shp[2] >= 512 else 20
        groups = x.view(shp[0], 32, -1)
        record("gn_scale_shift", err, 1e-5, cuda_ms(stats, iters),
               cuda_ms(lambda: gn_mod.gn_scale_shift_plain(x, w, b, 32, eps), iters),
               f"{list(shp)} bf16 eps {eps:g} (error relative to max |scale|, |shift|)",
               *bound(nbytes(x, w, b, *got), 3.0 * x.numel(), "f32"),
               cuda_ms(lambda: torch.var_mean(groups, dim=2), iters), graph_ms(stats, iters))
        del x, got, want

    # fused GroupNorm+SiLU+conv3x3: UNet res-block chains, the skip concat,
    # the 8^2 level, the 4-channel output conv, the VAE's 512^2 level, and a
    # small float32 case. bf16: the plain version rounds the conv's result
    # and again after the bias, the kernel once: 3 ulps at max |y|; float32
    # 1e-4 of max |y| (sums in another order; TF32 is off).
    for (n, c, h, w_, co), dtype in (((5, 320, 64, 64, 320), bf16), ((5, 960, 64, 64, 320), bf16),
                                     ((5, 2560, 8, 8, 1280), bf16), ((5, 320, 64, 64, 4), bf16),
                                     ((5, 128, 512, 512, 128), bf16), ((2, 64, 16, 8, 96), f32)):
        x = (torch.randn(n, c, h, w_, device=dev, generator=gen) * 1.5 + 0.3).to(dtype)
        gw = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
        gb = 0.1 * torch.randn(c, device=dev, generator=gen)
        wt = (torch.randn(co, c, 3, 3, device=dev, generator=gen) * (9 * c) ** -0.5).to(dtype)
        bias = 0.1 * torch.randn(co, device=dev, generator=gen)
        got = conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
        want = conv_mod.gn_silu_conv3x3_plain(x, gw, gb, wt, bias, 32, 1e-5)
        rel = 3 * 2 ** -8 if dtype == bf16 else 1e-4
        gwd, gbd, biasd = gw.to(dtype), gb.to(dtype), bias.to(dtype)
        iters = 5 if h >= 512 else 20
        record("gn_silu_conv3x3", max_err(got, want), rel * float(want.float().abs().max()),
               cuda_ms(lambda: conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5), iters),
               cuda_ms(lambda: conv_mod.gn_silu_conv3x3_plain(x, gw, gb, wt, bias, 32, 1e-5),
                       iters),
               f"[{n},{c},{h},{w_}]->{co} {'bf16' if dtype == bf16 else 'f32'}",
               *bound(nbytes(x, wt, got, gw, gb, bias), 18.0 * c * co * n * h * w_,
                      "bf16" if dtype == bf16 else "f32"),
               cuda_ms(lambda: F.conv2d(F.silu(F.group_norm(x, 32, gwd, gbd, 1e-5)), wt, biasd,
                                        padding=1), iters))
        # the wrapper's two parts timed alone: the statistics launch and the
        # conv kernel itself
        def stats():
            return gn_mod.gn_scale_shift(x, gw, gb, 32, 1e-5)

        scale, shift = stats()
        variant = conv_mod.kernel_variant(dtype, co)
        conv_only = conv_alone(x, scale, shift, wt, bias, got, variant)
        conv_ms = cuda_ms(conv_only, iters)
        log(f"[phase2]   {variant} kernel; of which statistics {cuda_ms(stats, iters):.4f} ms, "
            f"conv kernel alone {conv_ms:.4f} ms = "
            f"{18e-9 * c * co * n * h * w_ / conv_ms:.0f} TFLOP/s")
        del x, wt, got, want
    results["gn_silu_conv3x3"]["variant"] = (
        "wgmma (conv_wgmma_kernel) for bf16 with more than 8 output channels; mma.sync "
        "(conv_mma_kernel) for f16 and bf16 up to 8 channels; fma (conv_fma_kernel) for f32")
    conv_checks(dev, gen)
    return results


def conv_alone(x, scale, shift, wt, bias, out, variant):
    """A function that launches only the conv kernel ``variant`` of the fused
    chain on ready-made statistics."""
    from mgldvsr_tpu_torch.ops.kernels import _build
    from mgldvsr_tpu_torch.ops.kernels import gn_silu_conv as conv_mod

    n, c, h, w = x.shape
    co = wt.shape[0]
    lib, stream = _build.library(), _build.stream_ptr(x.device)
    head = (x.data_ptr(), scale.data_ptr(), shift.data_ptr())
    if variant == "wgmma":
        relaid = conv_mod.relaid_weight(wt)
        args = (*head, relaid.data_ptr(), bias.data_ptr(), out.data_ptr(), n, c, relaid.shape[2],
                h, w, co, stream)
        entry = lib.mgld_gn_silu_conv_wgmma_bf16
    else:
        args = (*head, wt.data_ptr(), bias.data_ptr(), out.data_ptr(), n, c, h, w, co, stream)
        entry = getattr(lib, conv_mod._ENTRY[x.dtype])
    return lambda: _build.check(entry(*args), "conv")


def conv_checks(dev, gen) -> None:
    """The fused GroupNorm+SiLU+conv off the timed shapes: C and Co off the
    tensor-core kernel's tiles, narrow frames, a clipped variance, the re-laid
    weight, the chain's launches, and the ``mma.sync`` kernel against the
    tensor-core one."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.kernels import gn_silu_conv as conv_mod
    from mgldvsr_tpu_torch.ops.kernels import groupnorm as gn_mod

    bf16 = torch.bfloat16

    def case(n, c, h, w, co, mean=0.3):
        x = (torch.randn(n, c, h, w, device=dev, generator=gen) * 1.5 + mean).to(bf16)
        gw = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
        gb = 0.1 * torch.randn(c, device=dev, generator=gen)
        wt = (torch.randn(co, c, 3, 3, device=dev, generator=gen) * (9 * c) ** -0.5).to(bf16)
        return x, gw, gb, wt, (0.1 * torch.randn(co, device=dev, generator=gen)).to(bf16)

    def check(what, got, want, tol):
        err = max_err(got, want)
        log(f"[phase2] gn_silu_conv3x3 {what}: max_abs_err {err:.3e} (limit {tol:.3e})")
        if not err <= tol or not torch.isfinite(got).all():
            raise AssertionError(f"gn_silu_conv3x3 {what}: {err:.3e} > {tol:.3e}")

    # bf16 bias, as the towers' convs hold it; 3 ulps at max |y| as above
    for n, c, h, w, co, what in ((2, 96, 24, 40, 72, "C and Co off the 64 and 128 tiles"),
                                 (2, 64, 16, 1, 32, "a frame one pixel wide"),
                                 (5, 128, 8, 8, 200, "8x8 frames, an odd number of them"),
                                 (3, 64, 21, 7, 24, "narrow and ragged"),
                                 (1, 576, 16, 16, 64, "9 stages split among a cluster of 8"),
                                 (2, 1280, 8, 8, 96, "8x8 tiles, 20 stages among 8 blocks")):
        args = case(n, c, h, w, co)
        kernels.reset_launch_counts()
        got = conv_mod.gn_silu_conv3x3(*args, 32, 1e-5)
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        if counts != {"gn_scale_shift": 1, "gn_silu_conv3x3": 1, "gn_silu_conv3x3_wgmma": 1}:
            raise AssertionError(f"gn_silu_conv3x3: a bf16 chain launched {counts}")
        want = conv_mod.gn_silu_conv3x3_plain(*args, 32, 1e-5)
        check(f"[{n},{c},{h},{w}]->{co} bf16 ({what})", got, want, bf16_ulps(3, want))

    # x with mean >> std: E[x^2] - E[x]^2 cancels in fp32 and clips at 0 for
    # some groups, in one summation order and not in another. The chain must
    # stay finite, and the conv kernel on the plain version's statistics must
    # equal the plain version.
    x, gw, gb, wt, bias = case(2, 64, 16, 16, 64, mean=300.0)
    got = conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    scale, shift = gn_mod.gn_scale_shift(x, gw, gb, 32, 1e-5)
    if not (torch.isfinite(got).all() and float(scale.abs().max()) <= 1.2 * 1e-5 ** -0.5):
        raise AssertionError("gn_silu_conv3x3: the clipped variance gave a non-finite chain")
    scale, shift = (t.contiguous() for t in gn_mod.gn_scale_shift_plain(x, gw, gb, 32, 1e-5))
    conv_alone(x, scale, shift, wt, conv_mod.bias_fp32(bias), got, "wgmma")()
    want = conv_mod.gn_silu_conv3x3_plain(x, gw, gb, wt, bias, 32, 1e-5)
    check("[2,64,16,16]->64 bf16, x = 300 + noise, on the plain version's statistics", got, want,
          bf16_ulps(3, want))

    # the re-laid weight: a permute bit for bit, zeros beyond C, made once
    x, gw, gb, wt, bias = case(2, 96, 16, 16, 40)
    made = conv_mod._derived.made
    relaid = conv_mod.relaid_weight(wt)
    if not (relaid.shape == (9, 40, 128) and not relaid[:, :, 96:].any()
            and torch.equal(relaid[:, :, :96], wt.permute(2, 3, 0, 1).reshape(9, 40, 96))):
        raise AssertionError("gn_silu_conv3x3: the re-laid weight is not the permuted weight")
    conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    if conv_mod.relaid_weight(wt) is not relaid or conv_mod._derived.made != made + 2:
        raise AssertionError("gn_silu_conv3x3: the weight or the bias was laid out again")
    wt.mul_(2)
    if not torch.equal(conv_mod.relaid_weight(wt), relaid * 2):
        raise AssertionError("gn_silu_conv3x3: an in-place update left a stale re-laid weight")
    log("[phase2] gn_silu_conv3x3 re-laid weight [40,96,3,3] -> [9,40,128]: equals the permute "
        "bit for bit, made once for two calls, made again after an in-place update")

    # the mma.sync kernel (kept for f16 and for up to 8 output channels) on a
    # shape that bf16 sends to the tensor-core kernel: bf16 products summed in
    # fp32 in another order, SiLU rounded by two formulas (exp and divide
    # there, tanh here): 2 ulps at max |y|, one whole step of the largest
    x, gw, gb, wt, bias = case(2, 320, 32, 32, 320)
    new = conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    old = torch.empty_like(new)
    scale, shift = gn_mod.gn_scale_shift(x, gw, gb, 32, 1e-5)
    conv_alone(x, scale, shift, wt, conv_mod.bias_fp32(bias), old, "mma")()
    check("[2,320,32,32]->320 bf16, mma.sync kernel vs wgmma kernel", old, new, bf16_ulps(2, new))


def tiny_config(frames: int = 5):
    from mgldvsr_tpu_torch.flow.raft import RAFTConfig
    from mgldvsr_tpu_torch.infer.pipeline import PipelineConfig
    from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig
    from mgldvsr_tpu_torch.models.unet import StructCondConfig, UNetConfig
    from mgldvsr_tpu_torch.models.vae import VAEConfig

    return PipelineConfig(
        num_frames=frames, ddpm_steps=2,
        unet=UNetConfig(model_channels=32, num_head_channels=16, context_dim=32,
                        semb_channels=32, channel_mult=(1, 2), attention_resolutions=(1, 2),
                        num_frames=frames),
        structcond=StructCondConfig(model_channels=32, out_channels=32, channel_mult=(1, 1),
                                    attention_resolutions=(1, 2), num_frames=frames),
        vae=VAEConfig(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, num_frames=frames,
                      enable_fusion=True, num_fuse_block=1),
        clip=CLIPTextConfig(width=32, heads=2, layers=2),
        raft=RAFTConfig(iters=2))


def phase3(seed: int, card: str, fused: bool) -> float:
    """The tiny restore on the card against the CPU, in the default or the
    fused configuration."""
    import torch

    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
    from mgldvsr_tpu_torch.ops import kernels

    cpu, gpu = tiny_pipelines(seed)
    cfg = cpu.cfg
    frames = upscale_frames(torch.from_numpy(lq_clip(seed + 1, 64)), 4)
    with fused_switch(fused):
        want = cpu.restore_segment(frames, deterministic=True)
        kernels.reset_launch_counts()
        got = gpu.restore_segment(frames.cuda(), deterministic=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    err = max_err(got.cpu(), want)
    log(f"[phase3] tiny 256x256 fp32 2 steps, fused conv {'on' if fused else 'off'}: card vs "
        f"CPU max_abs_err {err:.3e} (limit 1e-3), launches {counts}  [{card}]")
    if got.shape != (5, 256, 256, 3) or not torch.isfinite(got).all():
        raise AssertionError(f"phase 3 output {tuple(got.shape)} is not finite [5,256,256,3]")
    if not err <= 1e-3:
        raise AssertionError(f"phase 3: card and CPU disagree ({err:.3e})")
    must = ["guidance_residual", "guidance_scatter", "attention", "corr_lookup",
            "fused_group_norm"]
    for name in must + list(FUSED_ONLY) * fused:
        if counts[name] == 0:
            raise AssertionError(f"phase 3: kernel {name} was never launched")
    guided = (counts["guidance_residual"], counts["guidance_scatter"])
    if guided != (cfg.ddpm_steps,) * 2 or any(counts[name] for name in STANDALONE):
        raise AssertionError(f"phase 3: guidance pair launches {guided} in {cfg.ddpm_steps} "
                             f"steps, standalone warp {[counts[n] for n in STANDALONE]}")
    if not fused and any(counts[name] for name in FUSED_ONLY):
        raise AssertionError(f"phase 3: {FUSED_ONLY} launched with the switch off")
    if counts["corr_lookup"] != cfg.raft.iters:
        raise AssertionError(f"phase 3: {counts['corr_lookup']} lookup launches for "
                             f"{cfg.raft.iters} RAFT iterations of one batched call")
    return err


def tiny_pipelines(seed: int):
    """The tiny config on the CPU and on the card with the same seeded
    weights, RAFT calmed."""
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights

    cfg = tiny_config()
    cpu = MGLDVSRPipeline(cfg, "cpu")
    init_pipeline_weights(cpu, seed)
    calm_raft(cpu)
    gpu = MGLDVSRPipeline(cfg)
    for name, tower in gpu.towers().items():
        tower.load_state_dict(cpu.towers()[name].state_dict(), strict=True)
    return cpu, gpu


def phase3_tile(seed: int, card: str, fused: bool) -> float:
    """The tiny tile and latent protocols on the card against the CPU."""
    import torch

    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
    from mgldvsr_tpu_torch.ops import kernels

    cpu, gpu = tiny_pipelines(seed)
    steps = cpu.cfg.ddpm_steps
    worst = 0.0
    awkward = torch.from_numpy(lq_clip(seed + 3, 16)[:, :13, :11].copy())
    kw = dict(pch_size=64, pch_stride=48, min_side=64, tile=4, tile_overlap=2, deterministic=True)
    with fused_switch(fused):
        for patch_batch in (1, 2):
            want = cpu.restore_video(awkward, patch_batch=patch_batch, **kw)
            kernels.reset_launch_counts()
            got = gpu.restore_video(awkward.cuda(), patch_batch=patch_batch, **kw)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            err = max_err(got.cpu(), want)
            groups = 2 // patch_batch
            log(f"[phase3] tile protocol 13x11 -> 66x44, two 64px patches of nine 4-latent "
                f"tiles, {patch_batch} a group, fused conv {'on' if fused else 'off'}: card vs "
                f"CPU max_abs_err {err:.3e} (limit 1e-3), guidance launches "
                f"{counts['guidance_residual']} / {counts['guidance_scatter']} for {groups} "
                f"groups of {steps} steps  [{card}]")
            if got.shape != (5, 66, 44, 3) or not torch.isfinite(got).all() or not err <= 1e-3:
                raise AssertionError(f"phase 3 tile protocol: {tuple(got.shape)}, {err:.3e}")
            if not counts["guidance_residual"] == counts["guidance_scatter"] == steps * groups:
                raise AssertionError(f"phase 3 tile protocol: guidance launches {counts}")
            worst = max(worst, err)
        frames = upscale_frames(torch.from_numpy(lq_clip(seed + 4, 16)), 4)
        want, want_lat = cpu.restore_with_latents(frames, deterministic=True)
        kernels.reset_launch_counts()
        got, lat = gpu.restore_with_latents(frames.cuda(), deterministic=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    err, err_lat = max_err(got.cpu(), want), max_err(lat.cpu(), want_lat)
    lat_tol = 1e-3 * max(1.0, float(want_lat.abs().max()))
    log(f"[phase3] latent protocol 64x64, fused conv {'on' if fused else 'off'}: card vs CPU "
        f"frames max_abs_err {err:.3e} (limit 1e-3), latents {err_lat:.3e} (limit 1e-3 of max "
        f"|latent| {float(want_lat.abs().max()):.2f}), guidance launches "
        f"{counts['guidance_residual']}  [{card}]")
    if got.shape != (5, 64, 64, 3) or lat.shape != (5, 8, 8, 4):
        raise AssertionError(f"phase 3 latent protocol: shapes {tuple(got.shape)}, "
                             f"{tuple(lat.shape)}")
    if not (err <= 1e-3 and err_lat <= lat_tol and counts["guidance_residual"] == steps):
        raise AssertionError(f"phase 3 latent protocol: {err:.3e}, {err_lat:.3e}, {counts}")
    return max(worst, err)


def full_config(steps: int):
    import torch

    from mgldvsr_tpu_torch.flow.raft import RAFTConfig
    from mgldvsr_tpu_torch.infer.pipeline import PipelineConfig
    from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig
    from mgldvsr_tpu_torch.models.unet import StructCondConfig, UNetConfig
    from mgldvsr_tpu_torch.models.vae import VAEConfig

    bf16 = torch.bfloat16
    return PipelineConfig(
        num_frames=5, ddpm_steps=steps,
        unet=UNetConfig(num_frames=5, dtype=bf16),
        structcond=StructCondConfig(num_frames=5, dtype=bf16),
        vae=VAEConfig(num_frames=5, enable_fusion=True, dtype=bf16),
        clip=CLIPTextConfig(dtype=bf16),
        raft=RAFTConfig(iters=10))


def full_pipeline(seed: int, steps: int):
    """The full-width pipeline with seeded weights and the 512px test clip."""
    import torch

    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, upscale_frames
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights

    t0 = time.perf_counter()
    pipe = MGLDVSRPipeline(full_config(steps))
    init_pipeline_weights(pipe, seed)
    calm_raft(pipe)
    pipe.cast_to_compute_dtypes()
    frames = upscale_frames(torch.from_numpy(lq_clip(seed + 2, 128)).cuda(), 4)
    torch.cuda.synchronize()
    log(f"[phase4] weights on the card in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for t in pipe.towers().values() for p in t.parameters()) / 1e6:.1f}"
        f"M parameters)")
    return pipe, frames


def full_restore(pipe, frames, seed: int, steps: int, card: str, fused: bool):
    """One restore at full width; returns (frames out, launch counts)."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels

    phase = "phase5" if fused else "phase4"
    gen = torch.Generator(device="cuda").manual_seed(seed)
    stages: dict = {}
    torch.cuda.reset_peak_memory_stats()
    with fused_switch(fused):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = pipe.restore_segment(frames, gen, stage_seconds=stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    stage_txt = ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
    log(f"[{phase}] fused conv {'on' if fused else 'off'}, 512x512, 5 frames, {steps} steps: "
        f"{stage_txt}; total {wall:.3f} s, {5 / wall:.4f} frames/s, sampler "
        f"{1000 * stages['sampler'] / steps:.2f} ms/step, peak {peak / 2**30:.2f} GiB  [{card}]")
    log(f"[{phase}] launches {counts}  [{card}]")
    if fused:
        from mgldvsr_tpu_torch.ops.kernels.gn_silu_conv import derived_bytes

        held, held_bytes = derived_bytes()
        log(f"[{phase}] re-laid weights and float32 biases kept for the tensor-core conv kernel: "
            f"{held} tensors, {held_bytes / 2**30:.3f} GiB")
    if out.shape != (5, 512, 512, 3):
        raise AssertionError(f"{phase} output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError(f"{phase} output is not finite in [0, 1]")
    for name in KERNELS:
        idle = (DEFAULT_ONLY if fused else FUSED_ONLY) + STANDALONE
        if (counts[name] == 0) != (name in idle):
            raise AssertionError(f"{phase}: kernel {name} was launched {counts[name]} times")
    # the guidance gradient: launch A and launch B once a step, nothing else
    if not counts["guidance_residual"] == counts["guidance_scatter"] == steps:
        raise AssertionError(f"{phase}: guidance launches {counts['guidance_residual']}, "
                             f"{counts['guidance_scatter']}, expected {steps} each")
    # 14 gated attention calls per step, all bf16 at head dim 64
    if not counts["attention_wgmma"] == counts["attention"] == 14 * steps:
        raise AssertionError(f"{phase}: {counts['attention']} attention launches, "
                             f"{counts['attention_wgmma']} on the tensor-core kernel, "
                             f"expected {14 * steps}")
    # RAFT runs once on the 8 frame pairs; each of its iterations is one lookup launch
    if counts["corr_lookup"] != pipe.cfg.raft.iters:
        raise AssertionError(f"{phase}: {counts['corr_lookup']} lookup launches, expected "
                             f"{pipe.cfg.raft.iters}")
    if fused:
        # 73 chains a step (45 in the UNet, 28 in the struct-cond encoder) and
        # 58 in the VAE, each two launches; all on the tensor-core kernel but
        # the UNet's 4-channel output conv and the VAE's 8- and 3-channel ones
        chains = 73 * steps + 58
        got = (counts["gn_silu_conv3x3"], counts["gn_scale_shift"],
               counts["gn_silu_conv3x3_wgmma"])
        if got != (chains, chains, chains - steps - 2):
            raise AssertionError(f"{phase}: (conv, statistics, tensor-core conv) launches {got}, "
                                 f"expected {(chains, chains, chains - steps - 2)}")
    return out, counts


def guidance_check(pipe, frames, seed: int) -> None:
    """The guidance gradient on this clip's flows and masks must be non-zero
    and equal its plain version (autograd of the loss through the plain
    warp) within 1e-6 of its largest value, in both modes."""
    import torch

    from mgldvsr_tpu_torch.ops.kernels.guidance import guidance_grad, guidance_grad_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    flows, masks = pipe.compute_flows(frames)
    lat = torch.randn(5, 64, 64, 4, device="cuda", generator=gen)
    occluded = float(masks[0].mean())
    if not occluded < 1.0:
        raise AssertionError("phase 4: every pixel is occluded; guidance does nothing")
    for mode in ("reference", "aligned"):
        grad = guidance_grad(lat, flows, masks, 5, mode)
        want = guidance_grad_plain(lat, flows, masks, 5, mode)
        err, tol = max_err(grad, want), 1e-6 * float(want.abs().max())
        log(f"[phase4] {mode}: flow |mean| {float(flows[0].abs().mean()):.4f} px at 1/8 res, "
            f"occluded share {occluded:.3f}, guidance grad norm {float(grad.norm()):.4e}, vs "
            f"the plain version max_abs_err {err:.3e} (limit {tol:.3e})")
        if not float(grad.norm()) > 0:
            raise AssertionError("phase 4: the guidance gradient is zero")
        if not err <= tol:
            raise AssertionError(f"phase 4: the guidance gradient differs from its plain "
                                 f"version ({err:.3e} > {tol:.3e})")


def full_latent_restore(pipe, frames, seed: int, steps: int, card: str) -> dict:
    """The latent protocol (``restore_with_latents``) at full width on phase
    4's pipeline and clip: frames [5,512,512,3] in [0, 1], latents
    [5,64,64,4], finite; every kernel of the default configuration launched,
    the guidance pair once a step."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(seed)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out, lat = pipe.restore_with_latents(frames, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    log(f"[phase4] latent protocol, 512x512, 5 frames, {steps} steps: total {wall:.3f} s, "
        f"frames {tuple(out.shape)}, latents {tuple(lat.shape)} |max| "
        f"{float(lat.abs().max()):.3f}; launches { {k: n for k, n in counts.items() if n} }  "
        f"[{card}]")
    if out.shape != (5, 512, 512, 3) or lat.shape != (5, 64, 64, 4):
        raise AssertionError(f"phase 4 latent: shapes {tuple(out.shape)}, {tuple(lat.shape)}")
    if not (torch.isfinite(out).all() and torch.isfinite(lat).all()
            and out.min() >= 0 and out.max() <= 1):
        raise AssertionError("phase 4 latent: frames not finite in [0, 1] or latents not finite")
    for name in KERNELS:
        if (counts[name] == 0) != (name in FUSED_ONLY + STANDALONE):
            raise AssertionError(f"phase 4 latent: kernel {name} was launched {counts[name]} "
                                 f"times")
    if not counts["guidance_residual"] == counts["guidance_scatter"] == steps:
        raise AssertionError(f"phase 4 latent: guidance launches {counts['guidance_residual']}, "
                             f"{counts['guidance_scatter']}, expected {steps} each")
    return counts


GEOMETRIES = {  # phase 6: (pch_size, pch_stride, patch pixels, patches at 720x1280)
    "auto": (0, 0, (512, 512), 6),
    "reference": (960, 750, (736, 960), 2),
}


@contextlib.contextmanager
def sampler_steps(pipe, steps: int):
    """Run the enclosed restores with ``steps`` respaced steps."""
    from mgldvsr_tpu_torch.core.schedules import respace_schedule

    before = pipe.sched
    pipe.sched = respace_schedule(pipe.base_sched, steps)
    try:
        yield
    finally:
        pipe.sched = before


def tile_restore(pipe, lq, seed: int, geometry: str, patch_batch):
    """One ``restore_video``: (frames, launch counts, stage seconds, wall
    seconds, peak device bytes above what was allocated before it)."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels

    size, stride = GEOMETRIES[geometry][:2]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    stages: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe.restore_video(lq, gen, pch_size=size, pch_stride=stride,
                             patch_batch=patch_batch, stage_seconds=stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, kernels.launch_counts(), stages, wall,
            torch.cuda.max_memory_allocated() - base)


def phase6(pipe, seed: int, steps: int, card: str) -> dict:
    """The tile protocol at full width on a 180x320 clip restored to
    720x1280: the bytes a patch adds to a group, then both geometries."""
    import math

    import torch

    from mgldvsr_tpu_torch.infer import pipeline as pipeline_mod

    lq = torch.from_numpy(lq_clip(seed + 5, 180, width=320)).cuda()
    per_px = {}
    with sampler_steps(pipe, 2):
        for geometry, (_, _, (ph, pw), _) in GEOMETRIES.items():
            peaks = [tile_restore(pipe, lq, seed, geometry, k)[4] for k in (1, 2)]
            per_px[geometry] = (peaks[1] - peaks[0]) / (ph * pw)
            log(f"[phase6] {geometry} geometry, {ph}x{pw} patches, 2 steps: peak above the "
                f"weights {peaks[0] / 2**30:.3f} GiB at one patch a group, "
                f"{peaks[1] / 2**30:.3f} GiB at two: a patch adds {peaks[1] - peaks[0]} B = "
                f"{per_px[geometry]:.0f} B a pixel  [{card}]")
    log(f"[phase6] PATCH_BYTES_PER_PIXEL in the pipeline {pipeline_mod.PATCH_BYTES_PER_PIXEL}, "
        f"the larger measured here {max(per_px.values()):.0f}  [{card}]")
    if not max(per_px.values()) <= pipeline_mod.PATCH_BYTES_PER_PIXEL:
        raise AssertionError(f"phase 6: a patch takes {max(per_px.values()):.0f} B a pixel, more "
                             f"than PATCH_BYTES_PER_PIXEL = {pipeline_mod.PATCH_BYTES_PER_PIXEL}")

    results = {}
    must = ("guidance_residual", "guidance_scatter", "attention", "corr_lookup", "channel_sums",
            "fused_group_norm")
    for geometry, n_steps in (("auto", steps), ("reference", 5)):
        _, _, (ph, pw), n_patches = GEOMETRIES[geometry]
        allowed = pipe.patch_batch_envelope(ph, pw)
        k = min(allowed, n_patches)
        groups = math.ceil(n_patches / k)
        with sampler_steps(pipe, n_steps):
            out, counts, stages, wall, peak = tile_restore(pipe, lq, seed, geometry, None)
        stage_txt = ", ".join(f"{name} {sec:.3f} s" for name, sec in stages.items())
        log(f"[phase6] ({'a' if geometry == 'auto' else 'b'}) {geometry} geometry: 180x320 -> "
            f"720x1280, {n_patches} patches of {ph}x{pw}, {k} a group ({groups} groups; the "
            f"envelope allows {allowed}), "
            f"{n_steps} steps: {stage_txt}; total {wall:.3f} s, {5 / wall:.4f} frames/s, peak "
            f"above the weights {peak / 2**30:.2f} GiB  [{card}]")
        log(f"[phase6] ({'a' if geometry == 'auto' else 'b'}) launches "
            f"{ {name: n for name, n in counts.items() if n} }  [{card}]")
        if out.shape != (5, 720, 1280, 3):
            raise AssertionError(f"phase 6 {geometry}: output shape {tuple(out.shape)}")
        if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
            raise AssertionError(f"phase 6 {geometry}: output is not finite in [0, 1]")
        for name in must:
            if counts[name] == 0:
                raise AssertionError(f"phase 6 {geometry}: kernel {name} was never launched")
        for name in FUSED_ONLY + STANDALONE:
            if counts[name]:
                raise AssertionError(f"phase 6 {geometry}: {name} launched {counts[name]} times")
        if not counts["guidance_residual"] == counts["guidance_scatter"] == n_steps * groups:
            raise AssertionError(f"phase 6 {geometry}: guidance launches "
                                 f"{counts['guidance_residual']}, {counts['guidance_scatter']}, "
                                 f"expected {n_steps} steps x {groups} groups")
        results[geometry] = {"counts": counts, "stages": stages, "wall_s": wall,
                             "frames_per_s": 5 / wall, "peak_bytes": peak, "patch_batch": k,
                             "steps": n_steps}
    results["bytes_per_pixel"] = per_px
    results["envelope"] = envelope_group(pipe, seed, card)
    return results


def envelope_group(pipe, seed: int, card: str) -> dict:
    """(c) The largest group the envelope allows at 736x960 patches, on a
    clip of 184 LQ rows (736 working rows) just wide enough that the 960/750
    grid holds that many patches, at two steps. The VAE's widest activation
    (256 channels at the patch's size) then holds K·5·256·736·960 elements,
    past 2^32 from K = 5. The frames must match those of one patch a group up
    to bf16's rounding: an index that wrapped would hand the group's later
    patches another patch's data."""
    import torch

    from mgldvsr_tpu_torch.infer.canvas import ImageSpliter

    k = pipe.patch_batch_envelope(736, 960)
    lq_w = 240
    while len(ImageSpliter((5, 736, 4 * lq_w + (-4 * lq_w) % 32, 3), 960, 750).positions) < k:
        lq_w += 8
    lq = torch.from_numpy(lq_clip(seed + 6, 184, width=lq_w)).cuda()
    elements = k * 5 * 256 * 736 * 960
    with sampler_steps(pipe, 2):
        out, counts, stages, wall, peak = tile_restore(pipe, lq, seed, "reference", k)
        one, _, _, wall_one, _ = tile_restore(pipe, lq, seed, "reference", 1)
    diff = (out - one).abs()
    err_max, err_mean = float(diff.max()), float(diff.mean())
    log(f"[phase6] (c) the envelope's group: 184x{lq_w} -> 736x{4 * lq_w}, {k} patches of "
        f"736x960 in one group ({elements} elements in the VAE's widest activation, "
        f"{elements / 2**32:.2f} x 2^32), 2 steps: total {wall:.3f} s (one patch a group "
        f"{wall_one:.3f} s), peak above the weights {peak / 2**30:.2f} GiB; vs one patch a "
        f"group max_abs_err {err_max:.3e} (limit 0.25), mean {err_mean:.3e} (limit 5e-3)  "
        f"[{card}]")
    if out.shape != (5, 736, 4 * lq_w, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"phase 6 (c): output {tuple(out.shape)} is not finite")
    if out.min() < 0 or out.max() > 1 or not (err_max <= 0.25 and err_mean <= 5e-3):
        raise AssertionError(f"phase 6 (c): {k} patches a group disagree with one a group "
                             f"(max {err_max:.3e}, mean {err_mean:.3e})")
    for name in ("attention", "corr_lookup", "channel_sums", "fused_group_norm"):
        if counts[name] == 0:
            raise AssertionError(f"phase 6 (c): kernel {name} was never launched")
    if not counts["guidance_residual"] == counts["guidance_scatter"] == 2:
        raise AssertionError(f"phase 6 (c): guidance launches {counts['guidance_residual']}, "
                             f"{counts['guidance_scatter']}, expected 2 steps x 1 group")
    return {"patch_batch": k, "elements": elements, "wall_s": wall, "peak_bytes": peak,
            "max_abs_err": err_max, "mean_abs_err": err_mean}


def phase7(card: str) -> None:
    """The inference CLI on the card in its three modes at tiny widths, then
    once at full width."""
    import tempfile

    import torch

    from mgldvsr_tpu_torch.cli import infer as cli
    from mgldvsr_tpu_torch.io.frames import codec, read_frame, write_frame
    from mgldvsr_tpu_torch.ops import kernels

    clip = (lq_clip(11, 32, frames=7, width=48) * 255).round().astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        lq = os.path.join(tmp, "lq")
        os.makedirs(os.path.join(lq, "clip0"))
        for i, frame in enumerate(clip):
            write_frame(os.path.join(lq, "clip0", f"{i:08d}.png"), frame)
        for mode, extra in (("fixed", ["--window-batch", "2"]), ("tile", []), ("latent", [])):
            out = os.path.join(tmp, mode)
            t0 = time.perf_counter()
            cli.main(["--seqs-path", lq, "--out-path", out, "--preset", "tiny", "--mode", mode,
                      "--ddpm-steps", "2", "--seed", "1", *extra])
            wall = time.perf_counter() - t0
            names = sorted(os.listdir(os.path.join(out, "clip0")))
            pngs = [n for n in names if n.endswith(".png")]
            npys = [n for n in names if n.endswith(".npy")]
            shapes = {read_frame(os.path.join(out, "clip0", n)).shape for n in pngs}
            lat_shapes = {np.load(os.path.join(out, "clip0", n)).shape for n in npys}
            log(f"[phase7] {mode} {' '.join(extra)}: {len(pngs)} frames written, read back as "
                f"{sorted(shapes)} through {codec()}; {len(npys)} latents {sorted(lat_shapes)}; "
                f"{wall:.2f} s  [{card}]")
            if pngs != [f"{i:08d}.png" for i in range(7)] or shapes != {(128, 192, 3)}:
                raise AssertionError(f"phase 7 {mode}: frames {pngs}, shapes {shapes}")
            want_npys = [f"{i:08d}.npy" for i in range(7)] if mode == "latent" else []
            if npys != want_npys or lat_shapes - {(16, 24, 4)}:
                raise AssertionError(f"phase 7 {mode}: latents {npys}, shapes {lat_shapes}")

        # --preset full: the shipped widths, bf16, seeded weights; fixed mode
        # on five 128x128 frames restored to 512x512, three steps
        full_clip = (lq_clip(12, 128) * 255).round().astype(np.uint8)
        os.makedirs(os.path.join(tmp, "lq_full", "clip0"))
        for i, frame in enumerate(full_clip):
            write_frame(os.path.join(tmp, "lq_full", "clip0", f"{i:08d}.png"), frame)
        out = os.path.join(tmp, "full")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cli.main(["--seqs-path", os.path.join(tmp, "lq_full"), "--out-path", out, "--preset",
                  "full", "--mode", "fixed", "--ddpm-steps", "3", "--seed", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        pngs = sorted(os.listdir(os.path.join(out, "clip0")))
        shapes = {read_frame(os.path.join(out, "clip0", n)).shape for n in pngs}
        log(f"[phase7] --preset full fixed, 128x128 -> 512x512, 3 steps: {len(pngs)} frames "
            f"written, read back as {sorted(shapes)}; {wall:.2f} s with the weights' set-up; "
            f"launches { {k: n for k, n in counts.items() if n} }  [{card}]")
        if pngs != [f"{i:08d}.png" for i in range(5)] or shapes != {(512, 512, 3)}:
            raise AssertionError(f"phase 7 full: frames {pngs}, shapes {shapes}")
        for name in KERNELS:
            if (counts[name] == 0) != (name in FUSED_ONLY + STANDALONE):
                raise AssertionError(f"phase 7 full: kernel {name} was launched {counts[name]} "
                                     f"times")
        if not (counts["guidance_residual"] == counts["guidance_scatter"] == 3
                and counts["attention_wgmma"] == counts["attention"] == 14 * 3):
            raise AssertionError(f"phase 7 full: launches {counts}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="respaced DDPM steps of phases 4, 5 and 6 (a)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from mgldvsr_tpu_torch.ops.kernels import _build

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[phase0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; tf32 off for matmul and cuDNN")

    so, secs = _build.build()
    _build.library()
    log(f"[phase1] built {so.name} in {secs:.2f} s (nvcc, sm_90a)")

    results = phase2(card)
    for fused in (False, True):
        phase3(args.seed, card, fused=fused)
        phase3_tile(args.seed, card, fused=fused)
    pipe, frames = full_pipeline(args.seed, args.steps)
    out4, counts4 = full_restore(pipe, frames, args.seed, args.steps, card, fused=False)
    guidance_check(pipe, frames, args.seed)
    counts_latent = full_latent_restore(pipe, frames, args.seed, args.steps, card)
    out5, counts5 = full_restore(pipe, frames, args.seed, args.steps, card, fused=True)
    log(f"[phase5] mean |fused - default| over the frames {float((out5 - out4).abs().mean()):.4e} "
        f"(bf16 rounds at other places in the two configurations; no limit)")
    del out4, out5
    tile = phase6(pipe, args.seed, args.steps, card)
    phase7(card)

    # launches: the count on the path that runs the kernel (the fused
    # configuration for the fused conv, the default one for the others)
    kernels = [{"name": name, "route": route, "source": src, "replaces": rep,
                "launches": (counts5 if name in FUSED_ONLY else counts4)[name],
                "launches_default": counts4[name], "launches_fused": counts5[name],
                "launches_latent": counts_latent[name],
                "launches_tile": tile["auto"]["counts"][name],
                "launches_tile_reference": tile["reference"]["counts"][name],
                **results[name]}
               for name, (route, src, rep) in KERNELS.items()]
    for entry in kernels:
        if entry["name"] == "attention":
            entry["wgmma_launches"] = counts4["attention_wgmma"]
            entry["strided_launches"] = counts4["attention_strided"]
        if entry["name"] == "gn_silu_conv3x3":
            entry["wgmma_launches"] = counts5["gn_silu_conv3x3_wgmma"]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

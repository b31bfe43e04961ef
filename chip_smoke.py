#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's restore path once on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 50] [--seed 0]

Phase 0  refuse to run without CUDA; print the card's name and power limit.
Phase 1  build the CUDA kernels from csrc/ (nvcc, sm_90a) and load them.
Phase 2  hold each kernel (the seven that replace a TPU kernel, and the
         statistics kernel of the fused chain) against its plain PyTorch
         version on the card at the main path's shapes; time both with CUDA
         events, time the one PyTorch library call that computes the same
         function where there is one, and compute the card's lower bound for
         the work. The kernels that take under 0.1 ms are also replayed from
         a CUDA graph, which gives their time on the device without the
         host's launch path (``device_ms``).
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
         with MGLD_FUSED_GN_CONV=1.
Phase 4  the default configuration at full width: 5 frames x4 to 512x512, 50
         guided steps, bf16 UNet / struct-cond / VAE / CLIP and float32 RAFT
         with seeded random weights, through
         ``MGLDVSRPipeline.restore_segment``; every kernel but the fused
         GroupNorm+SiLU+conv's two must have been launched by that run, and every
         gated attention call (14 per step) must have taken the tensor-core
         kernel.
Phase 5  the fused configuration (MGLD_FUSED_GN_CONV=1) at the same width,
         clip, seed and weights: every kernel but the channel sums (whose
         GroupNorms all head a fused chain) must have been launched,
         every chain as two launches (statistics, conv), and every bf16 chain
         with more than 8 output channels on the tensor-core kernel.

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


def lq_clip(seed: int, size: int, frames: int = 5) -> np.ndarray:
    """[T, size, size, 3] in [0,1]: a smooth seeded pattern moving 2 px
    right and 1 px down per frame, so that flows are non-zero."""
    rs = np.random.RandomState(seed)
    big = size + 4 * frames
    yy, xx = np.mgrid[0:big, 0:big].astype(np.float32) / big
    pattern = np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * (rs.uniform(1, 4) * xx + rs.uniform(1, 4) * yy
                                        + rs.uniform(0, 1)))
        for _ in range(3)], axis=-1)
    pattern += 0.05 * rs.rand(big, big, 3).astype(np.float32)
    clip = [pattern[f:f + size, 2 * f:2 * f + size] for f in range(frames)]
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

    # guidance warp: 2(t-2) = 6 latents of one 5-frame window at 64x64x4;
    # 4 taps of 2 flops and ~12 flops of weights per output element
    x = torch.randn(6, 64, 64, 4, device=dev, generator=gen)
    flow = torch.randn(6, 64, 64, 2, device=dev, generator=gen) * 3
    g = torch.randn(6, 64, 64, 4, device=dev, generator=gen)
    shape = "x[6,64,64,4] f32"
    warp_bound = bound(nbytes(x, flow, x), 20 * x.numel(), "f32")
    record("warp_forward", max_err(warp_mod.warp_forward(x, flow), warp_mod.warp_plain(x, flow)),
           1e-5, cuda_ms(lambda: warp_mod.warp_forward(x, flow)),
           cuda_ms(lambda: warp_mod.warp_plain(x, flow)), shape, *warp_bound,
           device_ms=graph_ms(lambda: warp_mod.warp_forward(x, flow)))
    xr = x.clone().requires_grad_(True)
    warp_mod.warp_plain(xr, flow).backward(g)
    dx = warp_mod.warp_dx(g, flow)
    err = max(max_err(dx, warp_mod.warp_dx_plain(g, flow)), max_err(dx, xr.grad))
    record("warp_dx", err, 1e-5, cuda_ms(lambda: warp_mod.warp_dx(g, flow)),
           cuda_ms(lambda: warp_mod.warp_dx_plain(g, flow)), shape + " (vs plain and autograd)",
           *warp_bound, device_ms=graph_ms(lambda: warp_mod.warp_dx(g, flow)))

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
    record("corr_lookup", max_err(got, corr_mod.lookup_corr_plain(pyr, coords, 4)),
           1e-4, cuda_ms(lambda: corr_mod.lookup_corr(pyr, coords, 4)),
           cuda_ms(lambda: corr_mod.lookup_corr_plain(pyr, coords, 4), iters=5),
           "pyramid [8,4096,64^2..8^2] f32, coords [8,64,64,2]",
           *bound(8 * 4096 * cells * 4 + nbytes(coords, got), 8.0 * got.numel(), "f32"),
           device_ms=graph_ms(lambda: corr_mod.lookup_corr(pyr, coords, 4)))
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
           device_ms=graph_ms(lambda: gn_mod.channel_sums(xb)))
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
        record("gn_scale_shift", err, 1e-5, cuda_ms(stats, iters),
               cuda_ms(lambda: gn_mod.gn_scale_shift_plain(x, w, b, 32, eps), iters),
               f"{list(shp)} bf16 eps {eps:g} (error relative to max |scale|, |shift|)",
               *bound(nbytes(x, w, b, *got), 3.0 * x.numel(), "f32"),
               device_ms=graph_ms(stats, iters))
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

    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, upscale_frames
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights
    from mgldvsr_tpu_torch.ops import kernels

    cfg = tiny_config()
    cpu = MGLDVSRPipeline(cfg, "cpu")
    init_pipeline_weights(cpu, seed)
    calm_raft(cpu)
    gpu = MGLDVSRPipeline(cfg)
    for name, tower in gpu.towers().items():
        tower.load_state_dict(cpu.towers()[name].state_dict(), strict=True)
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
    must = ["warp_forward", "warp_dx", "attention", "corr_lookup", "fused_group_norm"]
    for name in must + list(FUSED_ONLY) * fused:
        if counts[name] == 0:
            raise AssertionError(f"phase 3: kernel {name} was never launched")
    if not fused and any(counts[name] for name in FUSED_ONLY):
        raise AssertionError(f"phase 3: {FUSED_ONLY} launched with the switch off")
    if counts["corr_lookup"] != cfg.raft.iters:
        raise AssertionError(f"phase 3: {counts['corr_lookup']} lookup launches for "
                             f"{cfg.raft.iters} RAFT iterations of one batched call")
    return err


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
        if (counts[name] == 0) != (name in (DEFAULT_ONLY if fused else FUSED_ONLY)):
            raise AssertionError(f"{phase}: kernel {name} was launched {counts[name]} times")
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
    """The guidance gradient on this clip's flows must be non-zero."""
    import torch

    from mgldvsr_tpu_torch.core.diffusion import temporal_warp_loss

    gen = torch.Generator(device="cuda").manual_seed(seed)
    (ff, fb), masks = pipe.compute_flows(frames)
    lat = torch.randn(5, 64, 64, 4, device="cuda", generator=gen).requires_grad_(True)
    (grad,) = torch.autograd.grad(temporal_warp_loss(lat, (ff, fb), masks, 5), lat)
    gnorm = float(grad.norm())
    occluded = float(masks[0].mean())
    if not occluded < 1.0:
        raise AssertionError("phase 4: every pixel is occluded; guidance does nothing")
    log(f"[phase4] flow |mean| {float(ff.abs().mean()):.4f} px at 1/8 res, occluded share "
        f"{occluded:.3f}, guidance grad norm {gnorm:.4e}")
    if not gnorm > 0:
        raise AssertionError("phase 4: the guidance gradient is zero")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="respaced DDPM steps of phases 4 and 5")
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
    phase3(args.seed, card, fused=False)
    phase3(args.seed, card, fused=True)
    pipe, frames = full_pipeline(args.seed, args.steps)
    out4, counts4 = full_restore(pipe, frames, args.seed, args.steps, card, fused=False)
    guidance_check(pipe, frames, args.seed)
    out5, counts5 = full_restore(pipe, frames, args.seed, args.steps, card, fused=True)
    log(f"[phase5] mean |fused - default| over the frames {float((out5 - out4).abs().mean()):.4e} "
        f"(bf16 rounds at other places in the two configurations; no limit)")

    # launches: the count on the path that runs the kernel (the fused
    # configuration for the fused conv, the default one for the others)
    kernels = [{"name": name, "route": route, "source": src, "replaces": rep,
                "launches": (counts5 if name in FUSED_ONLY else counts4)[name],
                "launches_default": counts4[name], "launches_fused": counts5[name],
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

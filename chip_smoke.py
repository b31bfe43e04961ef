#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's restore path once on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 50] [--seed 0]

Phase 0  refuse to run without CUDA; print the card's name and power limit.
Phase 1  build the CUDA kernels from csrc/ (nvcc, sm_90a) and load them.
Phase 2  hold each kernel against its plain PyTorch version on the card at
         the main path's shapes; time both with CUDA events.
Phase 3  tiny config at 256x256, float32, 2 steps, deterministic: the same
         weights on the card (kernels) and on the CPU (plain versions) must
         give the same frames; the warp, attention and lookup kernels must
         have been launched.
Phase 4  the slice at full width: 5 frames x4 to 512x512, 50 guided steps,
         bf16 UNet / struct-cond / VAE / CLIP and float32 RAFT with seeded
         random weights, through ``MGLDVSRPipeline.restore_segment``; every
         kernel must have been launched by that run.

Prints one JSON line describing the kernels before the last line, and the
result line ``{"ok": true, "device": {...}}`` last. Any failure raises and
exits non-zero without the result line.
"""
from __future__ import annotations

import argparse
import json
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
}


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


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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


def phase2(card: str):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from mgldvsr_tpu_torch.flow.raft import build_corr_pyramid
    from mgldvsr_tpu_torch.ops.kernels import attention as attn_mod
    from mgldvsr_tpu_torch.ops.kernels import corr_lookup as corr_mod
    from mgldvsr_tpu_torch.ops.kernels import flow_warp as warp_mod
    from mgldvsr_tpu_torch.ops.kernels import groupnorm as gn_mod

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def record(name, err, tol, ms, plain_ms, shape):
        log(f"[phase2] {name} {shape}: max_abs_err {err:.3e} (limit {tol:.1e}) "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
        if not err <= tol:
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"({err:.3e} > {tol:.1e})")
        results.setdefault(name, {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    # guidance warp: 2(t-2) = 6 latents of one 5-frame window at 64x64x4
    x = torch.randn(6, 64, 64, 4, device=dev, generator=gen)
    flow = torch.randn(6, 64, 64, 2, device=dev, generator=gen) * 3
    g = torch.randn(6, 64, 64, 4, device=dev, generator=gen)
    shape = "x[6,64,64,4] f32"
    record("warp_forward", max_err(warp_mod.warp_forward(x, flow), warp_mod.warp_plain(x, flow)),
           1e-5, cuda_ms(lambda: warp_mod.warp_forward(x, flow)),
           cuda_ms(lambda: warp_mod.warp_plain(x, flow)), shape)
    xr = x.clone().requires_grad_(True)
    warp_mod.warp_plain(xr, flow).backward(g)
    dx = warp_mod.warp_dx(g, flow)
    err = max(max_err(dx, warp_mod.warp_dx_plain(g, flow)), max_err(dx, xr.grad))
    record("warp_dx", err, 1e-5, cuda_ms(lambda: warp_mod.warp_dx(g, flow)),
           cuda_ms(lambda: warp_mod.warp_dx_plain(g, flow)), shape + " (vs plain and autograd)")

    # attention: UNet self-attention at 64^2 (5 frames x 5 heads) and 32^2
    # (5 x 10), head dim 64, bf16; the plain version rounds its
    # probabilities to bf16, hence the limit
    for bh, n in ((25, 4096), (50, 1024), (20, 4096)):
        q, k, v = (torch.randn(bh, n, 64, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        out = attn_mod.attention(q, k, v)
        record("attention", max_err(out, attn_mod.attention_plain(q, k, v)), 2e-2,
               cuda_ms(lambda: attn_mod.attention(q, k, v), iters=10),
               cuda_ms(lambda: attn_mod.attention_plain(q, k, v), iters=10),
               f"[{bh},{n},64] bf16")
        del q, k, v, out

    # RAFT lookup: 8 frame pairs, 64x64 queries at 1/8 of 512px, 4 levels, r=4
    f1 = torch.randn(8, 256, 64, 64, device=dev, generator=gen)
    f2 = torch.randn(8, 256, 64, 64, device=dev, generator=gen)
    pyr = [p.contiguous() for p in build_corr_pyramid(f1, f2, 4)]
    gy, gx = torch.meshgrid(torch.arange(64.0, device=dev), torch.arange(64.0, device=dev),
                            indexing="ij")
    coords = (torch.stack([gx, gy], -1)[None]
              + torch.randn(8, 64, 64, 2, device=dev, generator=gen) * 4).contiguous()
    record("corr_lookup",
           max_err(corr_mod.lookup_corr(pyr, coords, 4), corr_mod.lookup_corr_plain(pyr, coords, 4)),
           1e-4, cuda_ms(lambda: corr_mod.lookup_corr(pyr, coords, 4)),
           cuda_ms(lambda: corr_mod.lookup_corr_plain(pyr, coords, 4), iters=5),
           "pyramid [8,4096,64^2..8^2] f32, coords [8,64,64,2]")
    del f1, f2, pyr

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
           cuda_ms(lambda: gn_mod.channel_sums_plain(xb)), "[5,128,512,512] bf16")
    return results


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


def phase3(seed: int, card: str) -> float:
    import torch

    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, upscale_frames
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights
    from mgldvsr_tpu_torch.ops import kernels

    cfg = tiny_config()
    cpu = MGLDVSRPipeline(cfg, "cpu")
    init_pipeline_weights(cpu, seed)
    calm_raft(cpu)
    gpu = MGLDVSRPipeline(cfg, "cuda")
    for name, tower in gpu.towers().items():
        tower.load_state_dict(cpu.towers()[name].state_dict(), strict=True)
    frames = upscale_frames(torch.from_numpy(lq_clip(seed + 1, 64)), 4)
    want = cpu.restore_segment(frames, deterministic=True)
    kernels.reset_launch_counts()
    got = gpu.restore_segment(frames.cuda(), deterministic=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    err = max_err(got.cpu(), want)
    log(f"[phase3] tiny 256x256 fp32 2 steps: card vs CPU max_abs_err {err:.3e} "
        f"(limit 1e-3), launches {counts}  [{card}]")
    if got.shape != (5, 256, 256, 3) or not torch.isfinite(got).all():
        raise AssertionError(f"phase 3 output {tuple(got.shape)} is not finite [5,256,256,3]")
    if not err <= 1e-3:
        raise AssertionError(f"phase 3: card and CPU disagree ({err:.3e})")
    for name in ("warp_forward", "warp_dx", "attention", "corr_lookup"):
        if counts[name] == 0:
            raise AssertionError(f"phase 3: kernel {name} was never launched")
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


def phase4(seed: int, steps: int, card: str):
    import torch

    from mgldvsr_tpu_torch.core.diffusion import temporal_warp_loss
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, upscale_frames
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights
    from mgldvsr_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    pipe = MGLDVSRPipeline(full_config(steps), "cuda")
    init_pipeline_weights(pipe, seed)
    calm_raft(pipe)
    pipe.cast_to_compute_dtypes()
    frames = upscale_frames(torch.from_numpy(lq_clip(seed + 2, 128)).cuda(), 4)
    torch.cuda.synchronize()
    log(f"[phase4] weights on the card in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for t in pipe.towers().values() for p in t.parameters()) / 1e6:.1f}"
        f"M parameters)")

    gen = torch.Generator(device="cuda").manual_seed(seed)
    stages: dict = {}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe.restore_segment(frames, gen, stage_seconds=stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    stage_txt = ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
    log(f"[phase4] 512x512, 5 frames, {steps} steps: {stage_txt}; total {wall:.3f} s, "
        f"{5 / wall:.4f} frames/s, sampler {1000 * stages['sampler'] / steps:.2f} ms/step, "
        f"peak {peak / 2**30:.2f} GiB  [{card}]")
    log(f"[phase4] launches {counts}  [{card}]")
    if out.shape != (5, 512, 512, 3):
        raise AssertionError(f"phase 4 output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError("phase 4 output is not finite in [0, 1]")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"phase 4: kernel {name} was never launched")

    # the guidance gradient on this clip's flows must be non-zero
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
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50, help="phase-4 respaced DDPM steps")
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
    phase3(args.seed, card)
    counts = phase4(args.seed, args.steps, card)

    kernels = [{"name": name, "route": route, "source": src, "replaces": rep,
                "launches": counts[name], **results[name]}
               for name, (route, src, rep) in KERNELS.items()]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The multi-device restore across ranks, held against one process.

  torchrun --nproc_per_node=N -m mgldvsr_tpu_torch.tools.multicard_check \\
      [--device cuda|cpu] [--preset full|tiny] [--steps 10] [--seed 0] \\
      [--init-method file:///PATH] [--timeout 300]

Every rank builds the same seeded pipeline (RAFT's last flow-head conv
scaled by 1e-2, so that the occlusion check leaves pixels for guidance) and
the same N consecutive 5-frame windows of a moving pattern (512x512 at the
full preset), one window a rank. All restores are deterministic (every draw
zero), so each check is bit for bit:

(a) ``restore_windows_sharded`` at boundary_weight 0 on every rank equals
    ``restore_segment`` of that rank's window;
(b) at boundary_weight 1 the frames of all ranks, gathered on rank 0, equal
    rank 0's restore of the N windows in lockstep in one process
    (:func:`lockstep`): the halo carried each window's first frame to the
    rank on its left at every step, and nothing else;
(c) tile mode: ``restore_video(patch_group=...)`` (a 180x320 clip to
    720x1280, 512px patches, one a group, 5 steps; 64px at the tiny preset)
    equals rank 0's ``restore_video`` alone.

Rank 0 prints one JSON line with the sampler's ms/step and the wall seconds
of each restore on each rank (the devices synchronised), and exits 1 when a
check fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def moving_clip(seed: int, size: int, frames: int, width: int | None = None) -> np.ndarray:
    """[frames, size, width, 3] in [0,1]: a smooth seeded pattern moving 2 px
    right and 1 px down per frame, so that flows are non-zero."""
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lockstep(pipe, frames: torch.Tensor, weight: float) -> dict:
    """D consecutive windows of ``frames`` [D·t,H,W,3] restored side by side
    in this process, deterministic, through ``sharded_step``: at every step
    the windows go right to left and each hands its first frame latent to
    the window on its left, as ``exchange_first`` sends it from rank r+1 to
    rank r. Each window's stages are ``restore_segment``'s, in its order.
    Returns the frames of every window, each window's kernel launches (its
    rank's, had each its own), the sampler's wall seconds for all, and the
    boundary term's inputs of window 0 at the last step."""
    from mgldvsr_tpu_torch.core.diffusion import SamplerConfig, initial_latents
    from mgldvsr_tpu_torch.infer.colorfix import apply_colorfix
    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.parallel.sharded_sampler import sharded_step

    cfg = pipe.cfg
    t = cfg.num_frames
    wins = [frames[s:s + t] for s in range(0, frames.shape[0], t)]
    d = len(wins)
    counts = [dict.fromkeys(kernels.launch_counts(), 0) for _ in wins]

    def counted(w, fn, *a, **k):
        before = kernels.launch_counts()
        out = fn(*a, **k)
        for name, n in kernels.launch_counts().items():
            counts[w][name] += n - before[name]
        return out

    st = []
    for w, win in enumerate(wins):
        pm1 = win * 2.0 - 1.0
        lat, fea = counted(w, pipe.encode, pm1, None, sample_posterior=False)
        context = counted(w, pipe.embed_empty_prompt, t)
        fl, masks = counted(w, pipe.compute_flows, win)
        st.append(dict(pm1=pm1, fea=fea, fl=fl, masks=masks, dn=pipe.denoise_fn(lat, context),
                       x=initial_latents(pipe.base_sched, lat, None, noise=torch.zeros_like(lat))))
    for w in range(d):
        if w < d - 1:
            bflow, bocc = counted(w, pipe.boundary_flow, wins[w][-1:], wins[w + 1][:1])
        else:  # no right neighbour: the term is multiplied by 0
            ff = st[w]["fl"][0]
            bflow, bocc = ff.new_zeros(1, *ff.shape[2:4], 2), ff.new_ones(1, *ff.shape[2:4], 1)
        st[w].update(bflow=bflow, bocc=bocc)
    scfg = SamplerConfig(num_frames=t, guidance_scale=cfg.guidance_scale,
                         guidance_mode=cfg.guidance_mode, temperature=0.0)
    _sync(pipe.device)
    t0 = time.perf_counter()
    for i in range(pipe.sched.num_timesteps - 1, -1, -1):
        firsts = {}
        for w in range(d - 1, -1, -1):

            def exchange(first, w=w):
                firsts[w] = first
                return (firsts[w + 1], 1) if w < d - 1 else (torch.zeros_like(first), 0)

            s = st[w]
            s["x"] = counted(w, sharded_step, pipe.sched, s["dn"], s["x"], i, None, scfg,
                             s["fl"], s["masks"], s["bflow"], s["bocc"], exchange, weight)
    _sync(pipe.device)
    sampler_s = time.perf_counter() - t0
    outs = []
    for w, s in enumerate(st):
        decoded = counted(w, pipe.decode, s["x"], s["fea"]).float()
        fixed = apply_colorfix(decoded, s["pm1"], cfg.colorfix)
        outs.append(torch.clamp((fixed + 1.0) / 2.0, 0.0, 1.0))
    boundary = (st[0]["x"][t - 1:], firsts.get(1), st[0]["bflow"], st[0]["bocc"])
    return dict(outs=outs, counts=counts, sampler_s=sampler_s, boundary=boundary)


def _pipeline(preset: str, steps: int, seed: int, device: torch.device):
    from mgldvsr_tpu_torch.cli.infer import tiny_pipeline_config
    from mgldvsr_tpu_torch.flow.raft import RAFTConfig
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, PipelineConfig
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights
    from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig
    from mgldvsr_tpu_torch.models.unet import StructCondConfig, UNetConfig
    from mgldvsr_tpu_torch.models.vae import VAEConfig

    if preset == "tiny":
        cfg = tiny_pipeline_config(torch.float32, ddpm_steps=steps)
    else:
        bf16 = torch.bfloat16
        cfg = PipelineConfig(ddpm_steps=steps, unet=UNetConfig(dtype=bf16),
                             structcond=StructCondConfig(dtype=bf16),
                             vae=VAEConfig(num_frames=5, enable_fusion=True, dtype=bf16),
                             clip=CLIPTextConfig(dtype=bf16), raft=RAFTConfig(iters=10))
    pipe = MGLDVSRPipeline(cfg, device=device)
    init_pipeline_weights(pipe, seed)
    with torch.no_grad():
        pipe.raft.update_block.flow_head.conv2.weight.mul_(1e-2)
    pipe.cast_to_compute_dtypes()
    return pipe


def _timed(device, fn):
    """(fn(), stage seconds, wall seconds), the device synchronised."""
    stages: dict = {}
    _sync(device)
    t0 = time.perf_counter()
    out = fn(stages)
    _sync(device)
    return out, stages, time.perf_counter() - t0


def run(args) -> int:
    from mgldvsr_tpu_torch.parallel import mesh
    from mgldvsr_tpu_torch.utils.precision import tf32_off

    import datetime

    device = mesh.init_group(args.device, args.init_method,
                             timeout=datetime.timedelta(seconds=args.timeout))
    try:
        with tf32_off():
            return _checks(args, device)
    finally:
        mesh.destroy()


def _checks(args, device) -> int:
    import torch.distributed as dist

    from mgldvsr_tpu_torch.core.schedules import respace_schedule
    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
    from mgldvsr_tpu_torch.parallel import mesh

    rank, world = mesh.rank(), mesh.world()
    t0 = time.perf_counter()
    pipe = _pipeline(args.preset, args.steps, args.seed, device)
    t = pipe.cfg.num_frames
    lq = 128 if args.preset == "full" else 16
    frames = upscale_frames(torch.from_numpy(
        moving_clip(args.seed + 1, lq, t * world)).to(device), pipe.cfg.sf)
    mine = frames[rank * t:(rank + 1) * t]
    setup_s = time.perf_counter() - t0
    # one warm restore, then each measured restore after a barrier
    pipe.restore_segment(mine, deterministic=True)
    report = {"world": world, "device": str(device), "preset": args.preset,
              "steps": args.steps, "setup_s": setup_s, "checks": {}}

    def on_all(fn):
        mesh.barrier()
        return _timed(device, fn)

    def per_rank(**values):
        v = torch.tensor(list(values.values()), dtype=torch.float64, device=device)
        out = [torch.empty_like(v) for _ in range(world)]
        dist.all_gather(out, v)
        return {k: [float(o[i]) for o in out] for i, k in enumerate(values)}

    seg, seg_st, seg_wall = on_all(
        lambda st: pipe.restore_segment(mine, deterministic=True, stage_seconds=st))
    w0, w0_st, w0_wall = on_all(lambda st: pipe.restore_windows_sharded(
        frames, boundary_weight=0.0, deterministic=True, stage_seconds=st))
    w1, w1_st, w1_wall = on_all(lambda st: pipe.restore_windows_sharded(
        frames, boundary_weight=1.0, deterministic=True, stage_seconds=st))
    gathered = [torch.empty_like(w1) for _ in range(world)]
    dist.all_gather(gathered, w1.contiguous())
    segments = [torch.empty_like(seg) for _ in range(world)]
    dist.all_gather(segments, seg.contiguous())
    ok_a = torch.tensor([int(torch.equal(w0, seg))], device=device)
    dist.all_reduce(ok_a, op=dist.ReduceOp.MIN)
    report["per_rank"] = per_rank(
        segment_sampler_ms=1000 * seg_st["sampler"] / args.steps, segment_wall_s=seg_wall,
        sharded_w0_sampler_ms=1000 * w0_st["sampler"] / args.steps, sharded_w0_wall_s=w0_wall,
        sharded_w1_sampler_ms=1000 * w1_st["sampler"] / args.steps, sharded_w1_wall_s=w1_wall)
    report["checks"]["a_w0_equals_restore_segment_on_every_rank"] = bool(ok_a.item())

    # (c) tile mode, the patches split over the ranks
    if args.preset == "full":
        lq_tile = torch.from_numpy(moving_clip(args.seed + 2, 180, t, width=320)).to(device)
        kw = dict(pch_size=0, pch_stride=0, patch_batch=1, deterministic=True)
    else:
        lq_tile = torch.from_numpy(moving_clip(args.seed + 2, 16, t)[:, :13, :11].copy()).to(device)
        kw = dict(pch_size=64, pch_stride=48, min_side=64, tile=4, tile_overlap=2,
                  patch_batch=1, deterministic=True)
    full_sched = pipe.sched
    pipe.sched = respace_schedule(pipe.base_sched, min(5, args.steps))
    try:
        tiled, _, tiled_wall = on_all(lambda st: pipe.restore_video(
            lq_tile, patch_group=mesh.subgroup(world), stage_seconds=st, **kw))
        report["per_rank"].update(per_rank(tile_patch_parallel_wall_s=tiled_wall))
        if rank == 0:
            alone, _, alone_wall = _timed(device, lambda st: pipe.restore_video(
                lq_tile, stage_seconds=st, **kw))
            report["tile_alone_wall_s"] = alone_wall
            report["tile_shape"] = list(alone.shape)
            report["checks"]["c_tile_patch_parallel_equals_alone"] = bool(torch.equal(tiled, alone))
        mesh.barrier()
    finally:
        pipe.sched = full_sched

    # (b) the gathered frames against the lockstep in one process, on rank 0
    if rank == 0:
        ref = lockstep(pipe, frames, 1.0)
        report["lockstep_sampler_ms"] = 1000 * ref["sampler_s"] / args.steps
        report["checks"]["b_w1_equals_lockstep"] = all(
            torch.equal(g, r) for g, r in zip(gathered, ref["outs"]))
        report["checks"]["boundary_term_moved_all_but_the_last"] = [
            not torch.equal(g, s) for g, s in zip(gathered, segments)]
        if device.type == "cuda":
            report["device_name"] = torch.cuda.get_device_name(device)
            report["cards"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
        moved = report["checks"]["boundary_term_moved_all_but_the_last"]
        ok = (report["checks"]["a_w0_equals_restore_segment_on_every_rank"]
              and report["checks"]["b_w1_equals_lockstep"]
              and report["checks"]["c_tile_patch_parallel_equals_alone"]
              and moved == [True] * (world - 1) + [False])
        report["ok"] = ok
        print(json.dumps(report), flush=True)
    else:
        ok = True
    flag = torch.tensor([int(ok)], device=device)
    dist.broadcast(flag, 0)
    return 0 if flag.item() else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default: NCCL) or cpu (gloo)")
    ap.add_argument("--preset", choices=["full", "tiny"], default="full")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-method", default=None,
                    help="the process group's init method (default env://, torchrun's)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait before the group aborts")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())

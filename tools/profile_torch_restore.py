#!/usr/bin/env python3
"""Profile one full-width restore of the PyTorch port on the GPU.

    python3 tools/profile_torch_restore.py [--steps 50] [--top 25]

Builds the chip smoke's full-width pipeline (seeded random weights, bf16
towers, float32 RAFT) and runs one warm-up restore. Then it times a warm
restore without the profiler (per-stage wall seconds), and profiles a third
with ``torch.profiler``: the summed kernel time against that run's wall
time, and the top kernels by device time.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_restore: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, upscale_frames
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights

    card = chip_smoke.card_line()
    pipe = MGLDVSRPipeline(chip_smoke.full_config(args.steps), "cuda")
    init_pipeline_weights(pipe, args.seed)
    chip_smoke.calm_raft(pipe)
    pipe.cast_to_compute_dtypes()
    frames = upscale_frames(torch.from_numpy(chip_smoke.lq_clip(args.seed + 2, 128)).cuda(), 4)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    pipe.restore_segment(frames, gen)  # warm-up: cuDNN heuristics, Triton, allocator

    stages: dict = {}
    t0 = time.perf_counter()
    pipe.restore_segment(frames, gen, stage_seconds=stages)
    wall = time.perf_counter() - t0
    print(card)
    print("warm run, no profiler (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; wall {wall:.3f}; sampler {1000 * stages['sampler'] / args.steps:.2f} ms/step")

    stages = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.restore_segment(frames, gen, stage_seconds=stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print("profiled run (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; wall {wall:.3f}")
    print(f"kernels {device_us / 1e6:.3f} s of {wall:.3f} s profiled wall "
          f"({100 * device_us / 1e6 / wall:.1f}% busy, kernel times summed)")
    print(events.table(sort_by="self_device_time_total", row_limit=args.top, max_name_column_width=70))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Profile warm full-width restores of the PyTorch port on the GPU.

    python3 tools/profile_torch_restore.py [--steps 50] [--top 25] [--fused]
    python3 tools/profile_torch_restore.py --compare PARENT_TREE [--fused]

One profile: builds the chip smoke's full-width pipeline (seeded random
weights, bf16 towers, float32 RAFT) and runs one warm-up restore. Then it
times a warm restore without the profiler (per-stage wall seconds), and
profiles a third with ``torch.profiler``: the summed kernel time against
that run's wall time, the attention kernels' share and launches, the
share of the fused GroupNorm+SiLU+conv kernels (conv and statistics), the
fused GroupNorm kernel's seconds and launches, the number of elementwise
launches, and the top kernels by device time. The
last line is one JSON object with those numbers. ``--fused`` sets
``MGLD_FUSED_GN_CONV=1``, so every GroupNorm -> SiLU -> conv3x3 chain runs
as the one fused kernel. ``--root DIR`` profiles the package and
``chip_smoke.py`` found in DIR instead of this checkout's.

``--compare PARENT_TREE`` sets an unpacked tree of another commit (for
example ``git archive <commit> | tar -x -C DIR``) against this checkout in
one call, so that both run on the same card and host: one process per
profile, in the order parent, change, change, parent, first in the default
and then in the fused configuration (with ``--fused``, the fused one alone),
and a table of the JSON lines at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTENTION_KERNELS = ("attention_kernel", "attention_wgmma_kernel")
# the fused GroupNorm+SiLU+conv chain: its conv kernels and its statistics kernels
CONV_KERNELS = ("conv_wgmma_kernel", "conv_mma_kernel", "conv_fma_kernel")
STATS_KERNELS = ("gn_stats_kernel", "channel_sums_kernel")
# the fused GroupNorm: the CUDA C++ kernel, and the Triton one of trees before it
GROUP_NORM_KERNELS = ("group_norm_kernel", "fused_gn_kernel")
# the guidance gradient: the guidance pair, and the warp kernels of trees before it
GUIDANCE_KERNELS = ("guidance_residual_kernel", "guidance_scatter_kernel", "warp_fwd_kernel",
                    "warp_dx_kernel")


def _total(events, names):
    """(summed device seconds, launches) of the kernels whose name holds one of ``names``."""
    hits = [e for e in events if any(name in e.key for name in names)]
    return sum(e.self_device_time_total for e in hits) / 1e6, sum(e.count for e in hits)


def profile_one(args) -> int:
    os.environ["MGLD_FUSED_GN_CONV"] = "1" if args.fused else "0"
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_restore: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, upscale_frames
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights

    card = chip_smoke.card_line()
    pipe = MGLDVSRPipeline(chip_smoke.full_config(args.steps))
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
    step_ms = 1000 * stages["sampler"] / args.steps
    print(card)
    print(f"tree {os.path.abspath(args.root)}, fused conv {'on' if args.fused else 'off'}")
    print("warm run, no profiler (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; wall {wall:.3f}; sampler {step_ms:.2f} ms/step")

    prof_stages: dict = {}
    # device activity only: recording the host's ~10^6 operator events as well
    # doubles the profiled wall time and takes a minute to summarise
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.restore_segment(frames, gen, stage_seconds=prof_stages)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in events) / 1e6
    attn_s, attn_n = _total(events, ATTENTION_KERNELS)
    conv_s, conv_n = _total(events, CONV_KERNELS)
    stats_s, stats_n = _total(events, STATS_KERNELS)
    gn_s, gn_n = _total(events, GROUP_NORM_KERNELS)
    guide_s, guide_n = _total(events, GUIDANCE_KERNELS)
    elementwise = sum(e.count for e in events if "elementwise_kernel" in e.key)
    print("profiled run (s): " + ", ".join(f"{k} {v:.3f}" for k, v in prof_stages.items())
          + f"; wall {prof_wall:.3f}")
    print(f"kernels {device_s:.3f} s of {prof_wall:.3f} s profiled wall "
          f"({100 * device_s / prof_wall:.1f}% busy, kernel times summed); attention "
          f"{attn_s:.3f} s = {100 * attn_s / device_s:.1f}% over {attn_n} launches; fused "
          f"GroupNorm+SiLU+conv: conv {conv_s:.3f} s = {100 * conv_s / device_s:.1f}% over "
          f"{conv_n} launches, statistics (with the default GroupNorm's channel sums) "
          f"{stats_s:.3f} s over {stats_n}; fused GroupNorm {gn_s:.3f} s over {gn_n} launches; "
          f"guidance {guide_s:.4f} s over {guide_n} launches; "
          f"{sum(e.count for e in events)} kernel launches, {elementwise} of them elementwise")
    print(averages.table(sort_by="self_device_time_total", row_limit=args.top,
                         max_name_column_width=70))
    print(json.dumps({
        "tree": args.root, "fused": args.fused, "card": card, "steps": args.steps,
        "sampler_ms_per_step": step_ms, "wall_s": wall, "stage_s": stages,
        "profiled_wall_s": prof_wall, "kernel_s": device_s, "attention_s": attn_s,
        "attention_share": attn_s / device_s,
        "attention_launches": attn_n, "conv_s": conv_s, "conv_launches": conv_n,
        "stats_s": stats_s, "stats_launches": stats_n,
        "group_norm_s": gn_s, "group_norm_launches": gn_n,
        "guidance_s": guide_s, "guidance_launches": guide_n,
        "kernel_launches": sum(e.count for e in events), "elementwise_launches": elementwise}))
    return 0


def compare(args) -> int:
    """Parent, change, change, parent in each configuration (the fused one
    alone with ``--fused``), one process each."""
    rows = []
    for fused in (True,) if args.fused else (False, True):
        for name, root in (("parent", args.compare), ("change", HERE), ("change", HERE),
                           ("parent", args.compare)):
            cmd = [sys.executable, os.path.abspath(__file__), "--root", root,
                   "--steps", str(args.steps), "--seed", str(args.seed), "--top", str(args.top)]
            out = subprocess.run(cmd + ["--fused"] * fused, capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stdout + out.stderr)
                return out.returncode
            result = json.loads(out.stdout.strip().splitlines()[-1])
            rows.append((name, result))
            print(f"== {name}, fused conv {'on' if fused else 'off'} ==")
            print("\n".join(out.stdout.strip().splitlines()[:-1]), flush=True)
    print(rows[0][1]["card"])
    print("tree   fused  sampler ms/step  wall s  kernel s  attention s (share, launches)  "
          "fused conv s (launches)  fused GroupNorm s (launches)  guidance s (launches)  "
          "kernel launches  elementwise launches")
    for name, r in rows:
        print(f"{name:6} {str(r['fused']):5}  {r['sampler_ms_per_step']:15.2f}  "
              f"{r['wall_s']:6.3f}  {r['kernel_s']:8.3f}  {r['attention_s']:.3f} "
              f"({100 * r['attention_share']:.1f}%, {r['attention_launches']})  "
              f"{r['conv_s']:.3f} ({r['conv_launches']})  "
              f"{r['group_norm_s']:.4f} ({r['group_norm_launches']})  "
              f"{r['guidance_s']:.4f} ({r['guidance_launches']})  "
              f"{r['kernel_launches']}  {r['elementwise_launches']}")
    print(json.dumps({"runs": [{"name": name, **r} for name, r in rows]}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused", action="store_true",
                    help="profile the fused GroupNorm+SiLU+conv configuration")
    ap.add_argument("--root", default=HERE,
                    help="tree whose package and chip_smoke.py are profiled")
    ap.add_argument("--compare", metavar="PARENT_TREE",
                    help="profile PARENT_TREE and this checkout in turns, both configurations")
    args = ap.parse_args()
    return compare(args) if args.compare else profile_one(args)


if __name__ == "__main__":
    sys.exit(main())

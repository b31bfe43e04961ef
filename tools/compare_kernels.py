#!/usr/bin/env python3
"""Time the port's standalone warp, the fused chain's statistics kernel and
the whole fused chain in two trees on one GPU, in turns.

    python3 tools/compare_kernels.py --parent PARENT_TREE
    python3 tools/compare_kernels.py --root TREE

``--parent`` takes an unpacked tree of another commit (for example ``git
archive <commit> | tar -x -C DIR`` under the ignored ``_chipcheck/``) and
runs it and this checkout in one process each, in the order parent, change,
change, parent, so that both are timed on the same card and host; a table
of the runs follows. ``--root`` times one tree: its package, this file's
timing code (``chip_smoke.py``'s CUDA-event, CUDA-graph and host clocks).

Each run, seeded and at the shapes the port's paths give the kernels:
``warp_forward`` on [4,512,512,3] (E*warp) and [1,512,512,3] (one swc pair)
float32 frames under a scattered, a smooth and a large flow, and on the swc
loss's stack [6,512,512,3]; ``gn_scale_shift`` at [5,320,64,64],
[5,960,64,64], [5,1280,8,8] and [5,128,512,512] bf16; ``gn_silu_conv3x3``,
the whole chain, at the full-width towers' main shapes. For each: CUDA-event
ms over repeated calls (``ms``), the device ms of the calls replayed from a
CUDA graph (``device_ms``) and the host microseconds a call takes to return
(``host_us``). The last line is one JSON object with every run.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAINS = ((5, 320, 64, 64, 320), (5, 960, 64, 64, 320), (5, 2560, 8, 8, 1280),
          (5, 320, 64, 64, 4), (5, 128, 512, 512, 128))
STATS = ((5, 320, 64, 64), (5, 960, 64, 64), (5, 1280, 8, 8), (5, 128, 512, 512))


def _timers():
    """This checkout's ``chip_smoke.py``, for its clocks and flows."""
    spec = importlib.util.spec_from_file_location("smoke_timers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from mgldvsr_tpu_torch.ops.kernels import _build
    from mgldvsr_tpu_torch.ops.kernels import flow_warp as warp_mod
    from mgldvsr_tpu_torch.ops.kernels import gn_silu_conv as conv_mod
    from mgldvsr_tpu_torch.ops.kernels import groupnorm as gn_mod

    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: no CUDA device")
    t = _timers()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    _build.library()
    rows = {}

    def time(name, fn, iters=50):
        fn()
        rows[name] = {"ms": t.cuda_ms(fn, iters), "device_ms": t.graph_ms(fn, iters),
                      "host_us": t.host_us(fn, 4 * iters)}

    gen = torch.Generator(device="cuda").manual_seed(9)
    for n, kinds in ((4, t.WARP_FLOWS), (1, t.WARP_FLOWS), (6, ("scattered",))):
        for kind in kinds:
            x = torch.rand(n, 512, 512, 3, device="cuda", generator=gen)
            flow = t.warp_flow(kind, n, 512, 512, gen)
            if not torch.equal(warp_mod.warp_forward(x, flow), warp_mod.warp_plain(x, flow)):
                rows[f"warp_forward [{n},512,512,3] {kind} differs from plain"] = True
            time(f"warp_forward [{n},512,512,3] {kind}", lambda: warp_mod.warp_forward(x, flow))
    bf16 = torch.bfloat16
    for shp in STATS:
        x = (torch.randn(shp, device="cuda", generator=gen) * 2 + 0.5).to(bf16)
        w = torch.randn(shp[1], device="cuda", generator=gen)
        b = torch.randn(shp[1], device="cuda", generator=gen)
        time(f"gn_scale_shift {list(shp)}", lambda: gn_mod.gn_scale_shift(x, w, b, 32, 1e-5),
             5 if shp[2] >= 512 else 50)
    for n, c, h, w_, co in CHAINS:
        x = (torch.randn(n, c, h, w_, device="cuda", generator=gen) * 1.5 + 0.3).to(bf16)
        gw = 1 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        gb = 0.1 * torch.randn(c, device="cuda", generator=gen)
        wt = (torch.randn(co, c, 3, 3, device="cuda", generator=gen) * (9 * c) ** -0.5).to(bf16)
        bias = (0.1 * torch.randn(co, device="cuda", generator=gen)).to(bf16)
        time(f"gn_silu_conv3x3 [{n},{c},{h},{w_}]->{co}",
             lambda: conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5),
             5 if h >= 512 else 50)
        del x, wt
    return {"root": os.path.abspath(root), "card": t.card_line(), "rows": rows}


def compare(parent: str) -> int:
    runs = []
    for name, root in (("parent", parent), ("change", HERE), ("change", HERE),
                       ("parent", parent)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr)
            return out.returncode
        runs.append({"name": name, **json.loads(out.stdout.strip().splitlines()[-1])})
    print(runs[0]["card"])
    print(f"{'kernel and shape':48} " + "  ".join(f"{r['name']:>26}" for r in runs))
    print(f"{'':48} " + "  ".join(f"{'ms / device ms / host us':>26}" for _ in runs))
    for key in runs[0]["rows"]:
        cells = []
        for r in runs:
            v = r["rows"].get(key)
            cells.append(f"{v['ms']:8.4f} {v['device_ms']:8.4f} {v['host_us']:7.1f}"
                         if isinstance(v, dict) else f"{str(v):>26}")
        print(f"{key:48} " + "  ".join(cells))
    print(json.dumps({"runs": runs}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="PARENT_TREE",
                    help="time PARENT_TREE and this checkout in turns")
    ap.add_argument("--root", default=HERE, help="the tree whose package is timed")
    args = ap.parse_args()
    if args.parent:
        return compare(args.parent)
    print(json.dumps(run_one(args.root)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

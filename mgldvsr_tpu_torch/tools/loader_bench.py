"""Host data-path throughput: the native C++ clip loader against the Python
disk path.

Writes a clip of random PNG frames (the bytes OpenCV's ``imwrite`` gives),
packs it, then measures clips/s of (a) the disk path: ``cv_ops.imread``,
scaling to [0, 1] and a numpy crop, on the calling thread; (b) the native
pool: every clip submitted, then fetched; (c) the native pool while the
main thread is busy for 0.8 of (b)'s time, where a GIL-free pool pays off:
``--busy numpy`` sums an array in a loop (GIL-holding host work), ``--busy
cuda`` runs a 2048^2 float32 matmul loop on the card, as a trainer feeding
it would. Without the native PNG codec only (a) is measured. Prints one
JSON line.

    python -m mgldvsr_tpu_torch.tools.loader_bench [--frames 5] [--size 128]
        [--src-size 360] [--iters 40] [--threads 4] [--busy numpy|cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

N_SOURCE_FRAMES = 30


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--size", type=int, default=128, help="crop size")
    ap.add_argument("--src-size", type=int, default=360)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--busy", choices=("numpy", "cuda"), default="numpy",
                    help="the main thread's work beside the native pool in (c)")
    args = ap.parse_args(argv)
    if args.frames >= N_SOURCE_FRAMES:
        ap.error(f"--frames must be below {N_SOURCE_FRAMES}")
    return args


def write_clip(root: str, src_size: int) -> None:
    from mgldvsr_tpu_torch.io.frames import encode_png

    rng = np.random.RandomState(0)
    clip = os.path.join(root, "000")
    os.makedirs(clip)
    for i in range(N_SOURCE_FRAMES):
        img = rng.randint(0, 256, (src_size, src_size, 3), np.uint8)
        with open(os.path.join(clip, f"{i:08d}.png"), "wb") as f:
            f.write(encode_png(img, opencv=True))


def busy_loop(kind: str):
    """A callable that keeps the main thread busy until a deadline."""
    if kind == "numpy":
        x = np.ones((256, 256), np.float32)

        def spin(until: float) -> int:
            n = 0
            while time.perf_counter() < until:
                float(x.sum())
                n += 1
            return n
        return spin
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("--busy cuda needs a CUDA device")
    a = torch.randn(2048, 2048, device="cuda")

    def spin(until: float) -> int:
        n = 0
        while time.perf_counter() < until:
            a @ a
            torch.cuda.synchronize()
            n += 1
        return n
    return spin


def run(args) -> dict:
    """The three measurements; without the native PNG codec the native
    ones are None and ``native`` says why."""
    from mgldvsr_tpu_torch import native
    from mgldvsr_tpu_torch.data import cv_ops
    from mgldvsr_tpu_torch.native.loader import STATUS, NativeClipLoader, pack_image_dir

    if not native.native_available():
        raise SystemExit("the native loader does not build here (no g++)")
    codecs = native.codecs()
    out = {"busy": args.busy, "frames": args.frames, "crop": args.size,
           "src_size": args.src_size, "iters": args.iters, "threads": args.threads,
           "codecs": list(codecs), "native": "ok" if "png" in codecs else STATUS[5]}
    work = tempfile.mkdtemp(prefix="loader_bench_")
    try:
        write_clip(os.path.join(work, "gt"), args.src_size)
        pack_image_dir(os.path.join(work, "gt"), os.path.join(work, "pk"))
        keysets, crops = [], []
        for it in range(args.iters):
            s = it % (N_SOURCE_FRAMES - args.frames)
            keysets.append([f"000/{s + j:08d}.png" for j in range(args.frames)])
            crops.append((it % 16, it % 13))
        size, n = args.size, args.iters

        t0 = time.perf_counter()
        for keys, (top, left) in zip(keysets, crops):
            frames = [cv_ops.imread(os.path.join(work, "gt", k)).astype(np.float32) / 255.0
                      for k in keys]
            np.stack([f[top:top + size, left:left + size] for f in frames])
        t_disk = time.perf_counter() - t0
        out["disk_clips_per_s"] = n / t_disk
        out.update(native_clips_per_s=None, native_busy_clips_per_s=None, speedup=None,
                   busy_s=None, busy_iters=None)
        if "png" not in codecs:
            return out

        loader = NativeClipLoader(os.path.join(work, "pk"), num_threads=args.threads)
        t0 = time.perf_counter()
        tickets = [loader.submit_clip(keys, top, left, size, size)
                   for keys, (top, left) in zip(keysets, crops)]
        for t in tickets:
            loader.fetch(t)
        t_native = time.perf_counter() - t0

        spin = busy_loop(args.busy)
        spin(time.perf_counter() + 0.05)  # warm: the first matmul's set-up
        t0 = time.perf_counter()
        tickets = [loader.submit_clip(keys, top, left, size, size)
                   for keys, (top, left) in zip(keysets, crops)]
        busy_s = 0.8 * t_native
        busy_iters = spin(t0 + busy_s)
        for t in tickets:
            loader.fetch(t)
        t_busy = time.perf_counter() - t0
        loader.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out.update(native_clips_per_s=n / t_native, native_busy_clips_per_s=n / t_busy,
               speedup=t_disk / t_native, busy_s=busy_s, busy_iters=busy_iters)
    return out


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

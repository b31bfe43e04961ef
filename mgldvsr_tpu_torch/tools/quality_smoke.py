"""End-to-end proof of the quality harness with seeded weights.

Counterpart of ``tools/quality_smoke.py``: synthetic GT clips, their LQ
frames (x1/4, bicubic) and a bicubic x4 baseline; NIQE's pristine model
fitted from the GT frames; a restore of the LQ clips through the inference
command line (seeded weights); then both the restore and the baseline
scored by :mod:`mgldvsr_tpu_torch.tools.quality_eval` against the GT with
every metric on seeded networks.

  python -m mgldvsr_tpu_torch.tools.quality_smoke [--workdir DIR]
      [--preset tiny|full] [--device cuda|cpu] [--clips 2] [--frames 5]
      [--gt-size 256] [--ddpm-steps N]

Without ``--workdir`` the files go to a temporary directory that is removed
at the end. Prints one JSON line: both restorations' mean metrics and the
verdicts (every metric finite; whether the bicubic baseline beats the
seeded restore on PSNR, which it should). Exits 1 when a metric is not
finite.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KEYS = ("psnr", "ssim", "lpips", "niqe", "ewarp", "fid_vs_against")


def make_clip_frames(clip_idx: int, n_frames: int, size: int):
    """Deterministic structured frames, [size, size, 3] uint8 RGB: smooth
    gradients and moving discs (a copy of ``tools/soak_train.py``'s)."""
    rng = np.random.default_rng(100 + clip_idx)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.stack([
        0.5 + 0.4 * np.sin(2 * np.pi * (xx * rng.uniform(1, 3) + rng.random())),
        0.5 + 0.4 * np.sin(2 * np.pi * (yy * rng.uniform(1, 3) + rng.random())),
        0.5 + 0.4 * np.sin(2 * np.pi * ((xx + yy) * rng.uniform(1, 2))),
    ], axis=-1)
    discs = [(rng.uniform(0.2, 0.8, 2), rng.uniform(0.05, 0.15),
              rng.uniform(0, 1, 3), rng.uniform(-0.02, 0.02, 2))
             for _ in range(4)]
    frames = []
    for t in range(n_frames):
        img = base.copy()
        for (c0, r, col, v) in discs:
            c = c0 + v * t
            m = ((xx - c[1]) ** 2 + (yy - c[0]) ** 2) < r ** 2
            img[m] = col
        frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return frames


def bicubic(img: np.ndarray, size: int) -> np.ndarray:
    """``cv_ops.resize(INTER_CUBIC)`` of a uint8 frame to size x size, rounded
    back to uint8."""
    from mgldvsr_tpu_torch.data import cv_ops

    out = cv_ops.resize(img.astype(np.float32), (size, size), interpolation=cv_ops.INTER_CUBIC)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def gray255(rgb: np.ndarray) -> np.ndarray:
    """A uint8 RGB frame as gray [0, 255] float64 (OpenCV's float32
    RGB-to-gray of the [0, 1] frame)."""
    from mgldvsr_tpu_torch.data import cv_ops

    g = cv_ops.cvtColor(rgb.astype(np.float32) / 255.0, cv_ops.COLOR_RGB2GRAY)
    return g.astype(np.float64) * 255.0


def make_data(wd: str, clips: int, frames: int, gt_size: int) -> dict:
    """GT, LQ and bicubic PNG clips under ``wd`` and the NIQE npz fitted
    from the GT frames."""
    from mgldvsr_tpu_torch.io.frames import write_frame
    from mgldvsr_tpu_torch.metrics.niqe import fit_niqe_params

    dirs = {d: os.path.join(wd, d) for d in ("gt", "lq", "bicubic", "ours")}
    gray = []
    for ci in range(clips):
        clip = f"{ci:03d}"
        for d in ("gt", "lq", "bicubic"):
            os.makedirs(os.path.join(dirs[d], clip), exist_ok=True)
        for t, img in enumerate(make_clip_frames(ci, frames, gt_size)):
            name = f"{t:08d}.png"
            lq = bicubic(img, gt_size // 4)
            write_frame(os.path.join(dirs["gt"], clip, name), img)
            write_frame(os.path.join(dirs["lq"], clip, name), lq)
            write_frame(os.path.join(dirs["bicubic"], clip, name), bicubic(lq, gt_size))
            gray.append(gray255(img))
    dirs["niqe"] = os.path.join(wd, "niqe_params.npz")
    fit_niqe_params(gray, out_path=dirs["niqe"])
    return dirs


def restore(dirs: dict, preset: str, device: str, steps: int) -> None:
    """The LQ clips through ``python -m mgldvsr_tpu_torch.cli.infer``."""
    cmd = [sys.executable, "-m", "mgldvsr_tpu_torch.cli.infer", "--seqs-path", dirs["lq"],
           "--out-path", dirs["ours"], "--mode", "fixed", "--preset", preset,
           "--ddpm-steps", str(steps), "--device", device]
    if device == "cpu":
        cmd.append("--no-bf16")
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stdout[-2000:], r.stderr[-2000:], file=sys.stderr)
        raise SystemExit(f"cli.infer failed rc={r.returncode}")


def score(restored: str, dirs: dict, device: str) -> dict:
    """The ``__mean__`` row of the quality harness on ``restored``, every
    network seeded (its per-clip lines are not printed)."""
    from mgldvsr_tpu_torch.tools import quality_eval

    with contextlib.redirect_stdout(io.StringIO()):
        rows = quality_eval.main([
            "--restored", restored, "--gt", dirs["gt"], "--lpips-ckpt", "random",
            "--raft-ckpt", "random", "--niqe-params", dirs["niqe"], "--fid-against", dirs["gt"],
            "--inception-ckpt", "random", "--device", device])
    return rows[-1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None,
                    help="where the clips go (default: a temporary directory, removed)")
    ap.add_argument("--preset", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--clips", type=int, default=2)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--gt-size", type=int, default=256)
    ap.add_argument("--ddpm-steps", type=int, default=None,
                    help="sampler steps of the restore (default 4 with --preset tiny, else 50)")
    args = ap.parse_args(argv)
    steps = args.ddpm_steps or (4 if args.preset == "tiny" else 50)

    with contextlib.ExitStack() as stack:
        wd = args.workdir or stack.enter_context(tempfile.TemporaryDirectory(prefix="qsmoke"))
        dirs = make_data(wd, args.clips, args.frames, args.gt_size)
        restore(dirs, args.preset, args.device, steps)
        ours = score(dirs["ours"], dirs, args.device)
        bic = score(dirs["bicubic"], dirs, args.device)
        finite = all(np.isfinite(row[k]) for row in (ours, bic) for k in KEYS if k in row)
        summary = {
            "ours": {k: round(ours[k], 4) for k in KEYS if k in ours},
            "bicubic": {k: round(bic[k], 4) for k in KEYS if k in bic},
            "device": ours["device"],
            "metrics_finite": bool(finite),
            "bicubic_beats_random_restore_psnr": bool(bic.get("psnr", 0) > ours.get("psnr", 0)),
            "ok": bool(finite),
        }
        with open(os.path.join(wd, "quality_smoke.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)

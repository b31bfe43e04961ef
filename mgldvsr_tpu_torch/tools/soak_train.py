"""Sustained training through the command line, with a checkpoint on
SIGUSR1, an unclean kill and a resume in the middle.

Counterpart of ``tools/soak_train.py``. It runs
``python -m mgldvsr_tpu_torch.cli.train`` as a user would:

  1. writes a small deterministic data set (structured clips a model can
     fit; stage 2 also their LQ frames and latents);
  2. starts the training command line as a subprocess and follows its
     ``metrics.jsonl``;
  3. at ``--sig-frac`` of the run sends SIGUSR1 (a forced checkpoint), waits
     for that checkpoint and one more step, then SIGKILL: a death with no
     shutdown;
  4. starts it again with ``--resume`` and checks that the step counter
     continues from the checkpoint, and that the steps run again after it
     log the losses they logged before the kill (the port's resume
     continues the data stream and the draws, so they are the same steps);
  5. writes ``WORKDIR/soak_summary.json``: the loss's head and tail means,
     steps/s (median, p10, p90), the peak device memory the trainer logged
     (``torch.cuda.max_memory_allocated``, every ``--log-every`` steps on
     the card) and the resume check.

  python -m mgldvsr_tpu_torch.tools.soak_train --stage 1 --steps 400 --workdir WORK
  python -m mgldvsr_tpu_torch.tools.soak_train --stage 2 --steps 200 --workdir WORK
  python -m mgldvsr_tpu_torch.tools.soak_train --tiny --device cpu --steps 6 \\
      --log-every 1 --workdir WORK                        # a smoke run on the CPU

Full width (the default) trains stage 1 with
``configs/mgldvsr_512_realbasicvsr_deg.yaml`` and stage 2 with
``configs/video_autoencoder_kl_64x64x4_resi.yaml`` at ``--size`` (GT
pixels), one clip a micro-step, ``--grad-accum 1``, seeded weights. An 80 GB
card holds both without ``use_checkpoint``. ``--packed`` packs stage 1's GT
frames into one record file and trains from it (``data.packed_root``).
Exits 1 when the resume check or the seam check fails, or (at full
width) the loss did not fall from the run's first steps to its last.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

from mgldvsr_tpu_torch.io import frames as frames_io
from mgldvsr_tpu_torch.tools.quality_smoke import make_clip_frames

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_FRAMES = 48  # the training command line's --tiny crops 32 pixels out of them


def make_stage1_data(root: str, n_clips: int, n_frames: int, size: int) -> None:
    """Clip folders ``100``, ``101``, ... of ``%08d.png`` frames (ids from
    100: the REDS4 validation clips 000, 011, 015, 020 are left out of
    training)."""
    for ci in range(n_clips):
        d = os.path.join(root, f"{100 + ci:03d}")
        os.makedirs(d, exist_ok=True)
        for t, img in enumerate(make_clip_frames(ci, n_frames, size)):
            frames_io.write_frame(os.path.join(d, f"{t:08d}.png"), img)


def make_stage2_data(gt_root: str, lq_root: str, lat_root: str, n_clips: int, n_frames: int,
                     size: int) -> None:
    """GT frames, their bicubic x1/4 LQ frames and N(0, 1) latents
    ([size/8, size/8, 4] float32), clip folders ``000``, ``001``, ..."""
    from mgldvsr_tpu_torch.data import cv_ops

    rng = np.random.default_rng(7)
    for ci in range(n_clips):
        for r in (gt_root, lq_root, lat_root):
            os.makedirs(os.path.join(r, f"{ci:03d}"), exist_ok=True)
        for t, img in enumerate(make_clip_frames(ci, n_frames, size)):
            name = f"{t:08d}"
            frames_io.write_frame(os.path.join(gt_root, f"{ci:03d}", name + ".png"), img)
            lq = cv_ops.resize(img, (size // 4, size // 4), interpolation=cv_ops.INTER_CUBIC)
            frames_io.write_frame(os.path.join(lq_root, f"{ci:03d}", name + ".png"), lq)
            np.save(os.path.join(lat_root, f"{ci:03d}", name + ".npy"),
                    rng.normal(size=(size // 8, size // 8, 4)).astype(np.float32))


def pack_frames(root: str, packed: str) -> int:
    """Every ``clip/%08d.png`` under ``root`` into one record file (the
    keys ``RealVSRRecurrentDataset(packed_root=)`` reads); returns the
    count."""
    from mgldvsr_tpu_torch.native.loader import pack_image_dir

    return pack_image_dir(root, packed)


def read_metrics(path: str) -> list:
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    pass  # a partial last line while the trainer writes it
    return rows


def command(args, logdir: str, resume: bool) -> list:
    """The training command line of one launch."""
    cmd = [sys.executable, "-m", "mgldvsr_tpu_torch.cli.train", "--stage", str(args.stage),
           "--logdir", logdir, "--max-steps", str(args.steps), "--grad-accum", "1",
           "--gt-size", str(args.size), "--ckpt-every", str(args.ckpt_every),
           "--log-every", str(args.log_every), "--image-every", str(10 ** 9),
           "--seed", "23", "--no-tb", "--device", args.device,
           "--data-root", os.path.join(args.workdir, "gt")]
    if args.stage == 1:
        if args.packed:
            cmd += ["--set", "data.packed_root=" + os.path.join(args.workdir, "packed")]
        if not args.tiny:
            cmd += ["--config", os.path.join(REPO, "configs", "mgldvsr_512_realbasicvsr_deg.yaml")]
    else:
        cmd += ["--lq-root", os.path.join(args.workdir, "lq"),
                "--latent-root", os.path.join(args.workdir, "lat")]
        if not args.tiny:
            cmd += ["--config",
                    os.path.join(REPO, "configs", "video_autoencoder_kl_64x64x4_resi.yaml")]
    if args.tiny:
        cmd += ["--tiny"]
    if resume:
        cmd += ["--resume"]
    return cmd


def launch(args, logdir: str, resume: bool, tag: str):
    """The training command line in a session of its own: its process group
    holds it and the data workers it spawns, which :func:`stop` ends
    together."""
    out = open(os.path.join(args.workdir, f"train_{tag}.log"), "ab")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    try:
        return subprocess.Popen(command(args, logdir, resume), cwd=REPO, stdout=out,
                                stderr=out, env=env, start_new_session=True)
    finally:
        out.close()


def stop(proc) -> None:
    """SIGKILL to the launch's whole process group (the trainer and its data
    workers, which a kill of the trainer alone would leave running), then
    reap the trainer."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass  # the group has ended
    proc.wait()


def wait_for_step(proc, metrics_path: str, target: int, timeout_s: float, label: str) -> list:
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        rows = read_metrics(metrics_path)
        if rows and rows[-1]["step"] >= target:
            return rows
        if proc.poll() is not None:
            rows = read_metrics(metrics_path)
            if rows and rows[-1]["step"] >= target:
                return rows
            raise RuntimeError(f"{label}: the trainer exited rc={proc.returncode} at step "
                               f"{rows[-1]['step'] if rows else 0} before {target}")
        time.sleep(0.2)
    raise TimeoutError(f"{label}: step {target} not reached in {timeout_s:.0f} s (last row: "
                       f"{read_metrics(metrics_path)[-1:]})")


def latest_ckpt_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir)
             if d.isdigit() and os.path.isfile(os.path.join(ckpt_dir, d, "state.pt"))]
    return max(steps) if steps else None


def rates(rows: list) -> list:
    """Steps/s between consecutive metric rows of one launch."""
    ts = [(r["step"], r["time"]) for r in rows]
    return [(s1 - s0) / (t1 - t0) for (s0, t0), (s1, t1) in zip(ts, ts[1:])
            if t1 > t0 and s1 > s0]


def quantiles(values: list) -> dict:
    v = sorted(values) or [0.0]
    return {"steps_per_sec_median": v[len(v) // 2], "steps_per_sec_p10": v[len(v) // 10],
            "steps_per_sec_p90": v[(len(v) * 9) // 10]}


def loss_key(rows: list):
    """The loss that should fall on a set the model can fit: stage 1's
    eps-MSE, stage 2's reconstruction, not an adversarial one."""
    for cand in ("loss", "rec_loss", "nll_loss"):
        if any(cand in r for r in rows):
            return cand
    cands = [k for k in rows[-1] if "loss" in k]
    return cands[0] if cands else None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", type=int, choices=[1, 2], default=1)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--size", type=int, default=512,
                    help=f"GT pixels (frames of {TINY_FRAMES} with --tiny, whose crop is 32)")
    ap.add_argument("--clips", type=int, default=4)
    ap.add_argument("--frames-per-clip", type=int, default=10)
    ap.add_argument("--sig-frac", type=float, default=0.4,
                    help="share of the run at which SIGUSR1 and then SIGKILL are sent")
    ap.add_argument("--ckpt-every", type=int, default=10 ** 9,
                    help="periodic checkpoints (default: none, so the mid-run checkpoint is "
                         "SIGUSR1's)")
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--startup-timeout", type=float, default=900,
                    help="seconds allowed for a launch's first metric row (imports, weights, "
                         "the first data, the kernels' first calls)")
    ap.add_argument("--step-timeout", type=float, default=30,
                    help="seconds allowed a step beyond the start-up")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="tiny widths (smoke runs)")
    ap.add_argument("--packed", action="store_true",
                    help="stage 1: pack the GT frames into one record file and train from it")
    args = ap.parse_args(argv)
    if args.tiny:
        args.size = TINY_FRAMES
    if args.packed and args.stage != 1:
        ap.error("--packed packs stage 1's GT frames")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    args.workdir = os.path.abspath(args.workdir)
    os.makedirs(args.workdir, exist_ok=True)
    gt = os.path.join(args.workdir, "gt")
    if not os.path.isdir(gt):
        if args.stage == 1:
            make_stage1_data(gt, args.clips, args.frames_per_clip, args.size)
        else:
            make_stage2_data(gt, os.path.join(args.workdir, "lq"),
                             os.path.join(args.workdir, "lat"), args.clips,
                             args.frames_per_clip, args.size)
    if args.packed and not os.path.exists(os.path.join(args.workdir, "packed.data")):
        print(f"packed {pack_frames(gt, os.path.join(args.workdir, 'packed'))} frames",
              flush=True)

    logdir = os.path.join(args.workdir, "run")
    metrics_path = os.path.join(logdir, "metrics.jsonl")
    ckpt_dir = os.path.join(logdir, "ckpt")
    sig_step = max(2, int(args.steps * args.sig_frac))
    budget = args.startup_timeout + args.steps * args.step_timeout

    # -- the first launch: to sig_step, SIGUSR1, its checkpoint, SIGKILL ------
    proc = launch(args, logdir, resume=False, tag="a")
    try:
        wait_for_step(proc, metrics_path, 1, args.startup_timeout, "start-up")
        wait_for_step(proc, metrics_path, sig_step, budget, "first launch")
        proc.send_signal(signal.SIGUSR1)
        print(f"SIGUSR1 sent at step >= {sig_step}", flush=True)
        t0, ck = time.time(), None
        while time.time() - t0 < 600:
            # a save is written to a temporary folder and renamed: a
            # numbered folder holding state.pt is whole
            ck = latest_ckpt_step(ckpt_dir)
            if ck is not None and ck >= sig_step:
                break
            if proc.poll() is not None:
                raise RuntimeError("the trainer died after SIGUSR1")
            time.sleep(0.2)
        if ck is None or ck < sig_step:
            raise TimeoutError("no checkpoint appeared after SIGUSR1")
        # one step beyond the checkpoint, to be run again after the resume
        try:
            wait_for_step(proc, metrics_path, ck + 1, 2 * args.step_timeout, "past the save")
        except (TimeoutError, RuntimeError):
            pass  # the seam is then checked on the loss's spread alone
    finally:
        stop(proc)
    rows1 = read_metrics(metrics_path)
    last_before = rows1[-1]["step"]
    print(f"killed at step {last_before}; checkpoint at step {ck}", flush=True)

    # -- the second launch: resume, run to --steps -----------------------------
    n_rows1 = len(rows1)
    proc = launch(args, logdir, resume=True, tag="b")
    try:
        rows = wait_for_step(proc, metrics_path, args.steps,
                             args.startup_timeout + (args.steps - ck) * args.step_timeout,
                             "second launch")
        proc.wait(timeout=600)
    finally:
        stop(proc)
    if len(rows) <= n_rows1:
        raise RuntimeError("the second launch logged no step: the first reached --steps "
                           "before SIGUSR1 (raise --steps or lower --sig-frac)")

    resumed_first = rows[n_rows1]["step"]
    key = loss_key(rows)
    losses = [(r["step"], r[key]) for r in rows if key in r]
    k = max(1, min(10, len(losses) // 4))
    head = float(np.mean([v for _, v in losses[:k]]))
    tail = float(np.mean([v for _, v in losses[-k:]]))
    # the seam: the steps logged before the kill and run again after the
    # resume must log the same loss; without such a step, the first losses
    # after the resume must be in family with the last ones before the kill
    # (within 10x their spread)
    before = {r["step"]: r[key] for r in rows1 if key in r}
    replayed = {r["step"]: r[key] for r in rows[n_rows1:] if key in r and r["step"] in before}
    pre = [v for s, v in losses[:n_rows1] if s <= ck][-max(k, 3):]
    post = [v for s, v in losses[n_rows1:]][:max(k, 3)]
    if replayed:
        seam = max(abs(v - before[s]) / max(abs(before[s]), 1e-12) for s, v in replayed.items())
        seam_ok = seam <= 1e-5
    else:
        seam = abs(float(np.mean(post)) - float(np.mean(pre)))
        seam_ok = seam < 10 * max(1e-6, max(pre) - min(pre))
    mem = [r["peak_mem_gb"] for r in rows if r.get("peak_mem_gb")]
    summary = {
        "stage": args.stage, "steps": args.steps, "gt_size": args.size,
        "device": args.device, "tiny": args.tiny, "packed": args.packed,
        "sig_step_target": sig_step, "ckpt_step": ck, "killed_at_step": last_before,
        "resumed_first_step": resumed_first, "resume_exact": resumed_first == ck + 1,
        "loss_key": key, "loss_head_mean": head, "loss_tail_mean": tail,
        "loss_decreased": tail < head,
        "seam_pre_mean": float(np.mean(pre)), "seam_post_mean": float(np.mean(post)),
        "seam_replayed_steps": sorted(replayed), "seam_difference": seam, "seam_ok": seam_ok,
        **quantiles(rates(rows1[max(1, n_rows1 // 4):]) + rates(rows[n_rows1 + 1:])),
        "peak_mem_first_gb": mem[0] if mem else None,
        "peak_mem_last_gb": mem[-1] if mem else None,
        "n_metric_rows": len(rows),
    }
    summary["ok"] = bool(summary["resume_exact"] and seam_ok and (args.tiny or tail < head))
    with open(os.path.join(args.workdir, "soak_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

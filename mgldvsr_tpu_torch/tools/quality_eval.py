"""Quality harness: score restored clips against a ground truth and/or
another restoration, on the card.

Counterpart of ``tools/quality_eval.py`` (the JAX harness), with the same
flags plus ``--device``:

  python -m mgldvsr_tpu_torch.tools.quality_eval --restored OURS [--gt GT]
      [--other REF] [--lpips-ckpt vgg.pth|random] [--niqe-params niqe.npz]
      [--raft-ckpt raft.pth|random] [--crop-border N]
      [--fid-against DIR --inception-ckpt pt_inception.pth|random]
      [--device cuda|cpu]

Directory layout: ``<dir>/<clip>/<frame>.png``. Prints one JSON line per
clip and a ``__mean__`` line: PSNR and SSIM (MATLAB parity, Y channel),
LPIPS against the GT, NIQE, E*warp, the mean and largest absolute
difference from ``--other``, and FID between the frames of ``--restored``
and of ``--fid-against``. Each line also says the device and that TF32 was
off: the tool scores in float32 with TF32 off for matmuls and cuDNN, and
puts both flags back when it is done, because a metric is compared across
runs and machines.

A network flag takes a torch checkpoint or ``random``: seeded weights (a
CPU ``torch.Generator`` seeded with 0, so the card and the CPU get the same
weights) that prove the path; their numbers mean nothing. Under ``random``
RAFT runs 4 iterations, with a checkpoint ``RAFTConfig()``'s 10.
Checkpoints load strictly under the upstream key names (the port's
modules keep them).

FID feeds the network [-1, 1], the range pt_inception expects (basicsr's
``inception.py:125-143``); the JAX harness feeds it [0, 1].

The tool runs on the card unless ``--device cpu`` is given, and raises
without one.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from mgldvsr_tpu_torch.utils.precision import tf32_off

FRAME_EXTENSIONS = (".png", ".jpg", ".jpeg")
BATCH = 8  # frames a network call (LPIPS, FID); E*warp groups RAFT's pairs by the same count


def load_clip(d: str) -> np.ndarray:
    """The clip's frames in name order: [T, H, W, 3] float32 in [0, 255]."""
    from mgldvsr_tpu_torch.io.frames import read_frame

    names = sorted(n for n in os.listdir(d) if n.lower().endswith(FRAME_EXTENSIONS))
    return np.stack([read_frame(os.path.join(d, n)) for n in names]).astype(np.float32)


def seeded(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` with seeded weights from a CPU generator seeded with 0."""
    from mgldvsr_tpu_torch.io.init_weights import init_module_weights

    return init_module_weights(module, torch.Generator().manual_seed(0))


def build_lpips(ckpt: str, device) -> torch.nn.Module:
    """taming's LPIPS (VGG16 and the linear heads): ``random`` or a full
    state dict under ``net.slice*`` / ``lin*`` (its ``scaling_layer``
    constants are not state here). Seeded heads take the magnitude of their
    draws: trained LPIPS heads are non-negative, so a distance is a sum of
    non-negative terms, not a near cancellation."""
    from mgldvsr_tpu_torch.io.torch_ckpt import load_torch_state_dict
    from mgldvsr_tpu_torch.models.lpips import LPIPS

    lp = LPIPS()
    if ckpt == "random":
        seeded(lp)
        for name, p in lp.named_parameters():
            if name.startswith("lin"):
                p.data.abs_()
    else:
        sd = load_torch_state_dict(ckpt)
        lp.load_state_dict({k: v for k, v in sd.items() if not k.startswith("scaling_layer.")},
                           strict=True)
    return lp.to(device)


def build_raft(ckpt: str, device) -> torch.nn.Module:
    from mgldvsr_tpu_torch.flow.raft import RAFT, RAFTConfig
    from mgldvsr_tpu_torch.io.torch_ckpt import load_torch_state_dict, load_tower

    if ckpt == "random":
        raft = seeded(RAFT(RAFTConfig(iters=4)))
    else:
        raft = RAFT(RAFTConfig())
        load_tower(raft, load_torch_state_dict(ckpt), "", "raft")
    return raft.requires_grad_(False).eval().to(device)


def build_inception(ckpt: str, device) -> torch.nn.Module:
    """The FID tower with ``normalize_input=False``: :func:`fid_features`
    scales its input."""
    from mgldvsr_tpu_torch.metrics.fid import load_patched_inception
    from mgldvsr_tpu_torch.metrics.inception import InceptionV3FID

    if ckpt == "random":
        return seeded(InceptionV3FID()).to(device)
    return load_patched_inception(ckpt, device=device)


@torch.no_grad()
def lpips_score(lp, a01: np.ndarray, b01: np.ndarray, device) -> float:
    """Mean LPIPS over the frames of two [T, H, W, 3] clips in [0, 1]."""
    vals = []
    for i in range(0, len(a01), BATCH):
        a = torch.from_numpy(a01[i:i + BATCH]).to(device).permute(0, 3, 1, 2)
        b = torch.from_numpy(b01[i:i + BATCH]).to(device).permute(0, 3, 1, 2)
        vals.append(lp(a * 2 - 1, b * 2 - 1).float().cpu())
    return float(torch.cat(vals).mean())


@torch.no_grad()
def fid_features(model, frames01: np.ndarray, device) -> np.ndarray:
    """[N, 2048] pool3 features of [N, H, W, 3] frames in [0, 1], fed to
    the network as [-1, 1], ``BATCH`` frames a call."""
    from mgldvsr_tpu_torch.metrics.fid import extract_features

    def fn(batch):
        return model(torch.from_numpy(batch).to(device) * 2 - 1).float().cpu().numpy()

    return extract_features(fn, [frames01[i:i + BATCH] for i in range(0, len(frames01), BATCH)])


def ewarp_score(raft, frames01: np.ndarray, device) -> float:
    from mgldvsr_tpu_torch.metrics.temporal import calculate_ewarp

    return calculate_ewarp(frames01, raft, chunk_pairs=BATCH, device=device)


def niqe_score(frames255: np.ndarray, params: str) -> float:
    from mgldvsr_tpu_torch.metrics.niqe import calculate_niqe

    return float(np.mean([calculate_niqe(f, params_path=params) for f in frames255]))


def population(root: str) -> np.ndarray:
    """Every frame of every clip under ``root``, [N, H, W, 3] in [0, 1]."""
    clips = [load_clip(os.path.join(root, c)) for c in sorted(os.listdir(root))
             if os.path.isdir(os.path.join(root, c))]
    return np.concatenate(clips) / 255.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--restored", required=True)
    ap.add_argument("--gt", default=None)
    ap.add_argument("--other", default=None,
                    help="a second restoration (e.g. the reference repo's output) for direct "
                         "output-parity deltas")
    ap.add_argument("--lpips-ckpt", default=None,
                    help="taming LPIPS state dict, or 'random' (needs --gt)")
    ap.add_argument("--niqe-params", default=None, help="pristine NIQE npz")
    ap.add_argument("--raft-ckpt", default=None,
                    help="raft-things weights for E*warp, or 'random' (random flows are "
                         "meaningless; omit to skip E*warp)")
    ap.add_argument("--crop-border", type=int, default=0)
    ap.add_argument("--fid-against", default=None,
                    help="second directory: report FID between the two frame populations")
    ap.add_argument("--inception-ckpt", default=None,
                    help="pt_inception-2015-12-05 weights for FID, or 'random'")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.fid_against and not args.inception_ckpt:
        ap.error("--fid-against needs --inception-ckpt (a checkpoint or 'random')")
    return args


def main(argv=None) -> list:
    """Score the clips; prints and returns the rows, the ``__mean__`` row
    last."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quality_eval: no CUDA device; pass --device cpu to score on the CPU")
    with tf32_off():
        return score(args, device)


def score(args, device: torch.device) -> list:
    from mgldvsr_tpu_torch.metrics.fid import calculate_activation_statistics, calculate_fid
    from mgldvsr_tpu_torch.metrics.image import calculate_psnr, calculate_ssim

    where = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
             "tf32": False}
    lp = build_lpips(args.lpips_ckpt, device) if args.lpips_ckpt and args.gt else None
    raft = build_raft(args.raft_ckpt, device) if args.raft_ckpt else None

    clips = sorted(d for d in os.listdir(args.restored)
                   if os.path.isdir(os.path.join(args.restored, d)))
    rows, agg = [], {}
    for clip in clips:
        ours = load_clip(os.path.join(args.restored, clip))
        row = {"clip": clip, "frames": int(ours.shape[0])}
        if args.gt:
            gt = load_clip(os.path.join(args.gt, clip))
            row["psnr"] = float(np.mean([
                calculate_psnr(o, g, args.crop_border, test_y_channel=True)
                for o, g in zip(ours, gt)]))
            row["ssim"] = float(np.mean([
                calculate_ssim(o, g, args.crop_border, test_y_channel=True)
                for o, g in zip(ours, gt)]))
            if lp is not None:
                row["lpips"] = lpips_score(lp, ours / 255.0, gt / 255.0, device)
        if args.niqe_params:
            row["niqe"] = niqe_score(ours, args.niqe_params)
        if raft is not None:
            row["ewarp"] = ewarp_score(raft, ours / 255.0, device)
        if args.other:
            other = load_clip(os.path.join(args.other, clip))
            row["l1_vs_other"] = float(np.mean(np.abs(ours - other)))
            row["max_vs_other"] = float(np.max(np.abs(ours - other)))
        row.update(where)
        print(json.dumps(row), flush=True)
        rows.append(row)
        for k, v in row.items():
            if isinstance(v, float):
                agg.setdefault(k, []).append(v)
    final = {"clip": "__mean__", **{k: float(np.mean(v)) for k, v in agg.items()}}
    if args.fid_against:
        model = build_inception(args.inception_ckpt, device)
        mu1, s1 = calculate_activation_statistics(
            fid_features(model, population(args.restored), device))
        mu2, s2 = calculate_activation_statistics(
            fid_features(model, population(args.fid_against), device))
        final["fid_vs_against"] = calculate_fid(mu1, s1, mu2, s2)
    if agg or args.fid_against:
        final.update(where)
        print(json.dumps(final), flush=True)
        rows.append(final)
    return rows


if __name__ == "__main__":
    main()

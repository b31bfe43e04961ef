"""Dataset preparation: crop large GT frames into overlapping sub-images.

Counterpart of ``mgldvsr_tpu/cli/prepare_data.py`` (the reference's
``scripts/extract_sub_images.py``), used to build the REDS sub-image set
for stage-1 training: walk a folder of clip folders, slide a crop window
with a fixed step, keep a last flush window where the remainder passes a
threshold, write PNGs, one process a frame over ``--workers``:

  python -m mgldvsr_tpu_torch.cli.prepare_data --input REDS/train_sharp \\
      --output REDS/train_sharp_sub [--crop-size 480] [--step 240] \\
      [--thresh-size 48] [--workers 8] [--meta-info meta_info.txt]

The crop positions, file names (``<frame>_s<NNN>.png`` in the input's
relative clip folder) and meta-info lines (one relative path a line,
sorted) are the JAX command line's. Frames are read and written through
:mod:`mgldvsr_tpu_torch.io.frames` rather than OpenCV: PNG needs neither
PIL nor OpenCV, the other formats PIL. Crops are written as 8-bit RGB (a
gray or RGBA frame becomes RGB; the JAX command line keeps its channels).
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, Tuple

from mgldvsr_tpu_torch.io import frames

EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp")


def crop_positions(full: int, crop: int, step: int, thresh: int) -> List[int]:
    """Window starts covering ``full``: stride ``step``, and a last window
    flush with the end when the remainder passes ``thresh``."""
    if full <= crop:
        return [0]
    pos = list(range(0, full - crop + 1, step))
    if full - (pos[-1] + crop) > thresh:
        pos.append(full - crop)
    return pos


def extract_sub_images(img_path: str, out_dir: str, crop_size: int = 480, step: int = 240,
                       thresh_size: int = 48, compression: int = 3) -> List[str]:
    """Crop one frame into sub-images in ``out_dir``; returns their names."""
    img = frames.read_frame(img_path)
    h, w = img.shape[:2]
    base = os.path.splitext(os.path.basename(img_path))[0]
    names = []
    for y in crop_positions(h, crop_size, step, thresh_size):
        for x in crop_positions(w, crop_size, step, thresh_size):
            name = f"{base}_s{len(names) + 1:03d}.png"
            frames.write_frame(os.path.join(out_dir, name),
                               img[y:y + crop_size, x:x + crop_size], compression)
            names.append(name)
    return names


def _worker(job: Tuple[str, str, str, int, int, int, int]) -> List[str]:
    path, in_root, out_root, crop, step, thresh, comp = job
    # the whole relative clip path: train/000 and val/000 stay apart
    rel_dir = os.path.relpath(os.path.dirname(path), in_root)
    out_dir = os.path.join(out_root, rel_dir)
    os.makedirs(out_dir, exist_ok=True)
    return [os.path.join(rel_dir, n)
            for n in extract_sub_images(path, out_dir, crop, step, thresh, comp)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input", required=True, help="root of clip folders")
    ap.add_argument("--output", required=True)
    ap.add_argument("--crop-size", type=int, default=480)
    ap.add_argument("--step", type=int, default=240)
    ap.add_argument("--thresh-size", type=int, default=48)
    ap.add_argument("--compression", type=int, default=3, help="PNG zlib level, 0-9")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--meta-info", help="write a meta_info txt here")
    args = ap.parse_args(argv)

    jobs = [(os.path.join(root, f), args.input, args.output, args.crop_size, args.step,
             args.thresh_size, args.compression)
            for root, _, files in sorted(os.walk(args.input))
            for f in sorted(files) if f.lower().endswith(EXTENSIONS)]
    os.makedirs(args.output, exist_ok=True)
    all_names: List[str] = []
    if args.workers > 1:
        with ProcessPoolExecutor(max_workers=args.workers,
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            for names in ex.map(_worker, jobs):
                all_names.extend(names)
    else:
        for job in jobs:
            all_names.extend(_worker(job))
    if args.meta_info:
        with open(args.meta_info, "w") as f:
            f.write("\n".join(sorted(all_names)) + "\n")
    print(f"wrote {len(all_names)} sub-images from {len(jobs)} frames ({frames.codec()} codec)")


if __name__ == "__main__":
    main()

"""Training observability: console/JSONL metric logging, image grids.

Counterpart of ``mgldvsr_tpu/utils/logging.py``: ``MessageLogger`` prints
basicsr-style lines and appends JSONL records (and TensorBoard scalars),
``ImageLogger`` writes PNG grids through :mod:`mgldvsr_tpu_torch.io.frames`,
``env_info`` reports torch, CUDA and the card.
"""
from __future__ import annotations

import datetime
import json
import os
import time
from typing import Dict, Optional

import numpy as np

from mgldvsr_tpu_torch.io.frames import write_frame


class MessageLogger:
    def __init__(self, total_iters: int, log_path: Optional[str] = None,
                 print_freq: int = 100, tb=None):
        self.total_iters = total_iters
        self.print_freq = print_freq
        self.start = time.time()
        self.log_path = log_path
        self.tb = tb  # optional utils.tb.TBEventWriter
        if log_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)

    def __call__(self, step: int, metrics: Dict[str, float], lr: Optional[float] = None):
        record = {"step": step, "time": round(time.time() - self.start, 2)}
        if lr is not None:
            record["lr"] = lr
        record.update({k: float(v) for k, v in metrics.items()})
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self.tb is not None:
            self.tb.scalars(record, step)
        if step % self.print_freq == 0:
            elapsed = time.time() - self.start
            eta = elapsed / max(step, 1) * (self.total_iters - step)
            parts = [f"[{step}/{self.total_iters}]"]
            if lr is not None:
                parts.append(f"lr:{lr:.2e}")
            parts += [f"{k}:{float(v):.4f}" for k, v in metrics.items()]
            parts.append(f"eta:{datetime.timedelta(seconds=int(eta))}")
            print(" ".join(parts), flush=True)


def make_grid(images: np.ndarray, nrow: int = 4, pad: int = 2) -> np.ndarray:
    """[N,H,W,C] float [0,1] -> one grid image, white between the cells."""
    n, h, w, c = images.shape
    nr = -(-n // nrow)
    grid = np.ones((nr * (h + pad) + pad, nrow * (w + pad) + pad, c), dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        grid[y: y + h, x: x + w] = images[i]
    return grid


class ImageLogger:
    """Renders dicts of [N,H,W,3] float [0,1] RGB arrays to PNG grids under
    ``logdir/images/<split>/<key>_step<step>.png``."""

    def __init__(self, logdir: str, every_n_steps: int = 750, max_images: int = 4, tb=None):
        self.logdir = logdir
        self.every = every_n_steps
        self.max_images = max_images
        self.tb = tb  # optional utils.tb.TBEventWriter

    def should_log(self, step: int) -> bool:
        return step % self.every == 0

    def log_images(self, step: int, images: Dict[str, np.ndarray], split: str = "train"):
        outdir = os.path.join(self.logdir, "images", split)
        os.makedirs(outdir, exist_ok=True)
        for key, arr in images.items():
            arr = np.asarray(arr)[: self.max_images]
            grid = make_grid(np.clip(arr, 0, 1))
            path = os.path.join(outdir, f"{key}_step{step:08d}.png")
            write_frame(path, (grid * 255).astype(np.uint8))
            if self.tb is not None:
                self.tb.image(f"{split}/{key}", grid, step)


def env_info() -> str:
    import torch

    lines = [f"torch {torch.__version__}", f"cuda {torch.version.cuda}",
             f"cuda available {torch.cuda.is_available()}"]
    if torch.cuda.is_available():
        lines.append("devices " + str([torch.cuda.get_device_name(i)
                                       for i in range(torch.cuda.device_count())]))
    return "\n".join(lines)

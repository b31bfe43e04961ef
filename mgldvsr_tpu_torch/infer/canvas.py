"""Arbitrary-resolution tiled inference.

Counterpart of ``mgldvsr_tpu/infer/canvas.py``: the two levels of tiling
of the reference's ``oldcanvas_tile`` protocol.

1. Pixel space: the pre-upscaled frames are split into overlapping patches
   (:class:`ImageSpliter`, 960/750 by default), each restored on its own
   and gathered by overlap-averaging.
2. Latent space, at the level of the noise prediction: at every sampling
   step a 64-latent tile (overlap 32) slides over the patch's latent
   canvas, each tile gets its own struct-cond features and UNet eps, and
   the tiles are stitched with gaussian weights before one posterior
   update (:func:`make_tiled_denoise_fn`).

The JAX package scans over chunks of tiles padded with zero-weight dummy
tiles; here a Python loop runs the chunks and a short last chunk is simply
shorter. The stitched sum visits the tiles in the same order.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


def gaussian_tile_weights(tile_h: int, tile_w: int) -> np.ndarray:
    """Gaussian stitching weights, var = 0.01·size², with the reference's
    asymmetric midpoints: (w-1)/2 for x, h/2 for y."""
    var = 0.01
    norm = math.sqrt(2 * math.pi * var)
    mid_x = (tile_w - 1) / 2
    xs = np.exp(-((np.arange(tile_w) - mid_x) ** 2) / (tile_w * tile_w) / (2 * var)) / norm
    mid_y = tile_h / 2
    ys = np.exp(-((np.arange(tile_h) - mid_y) ** 2) / (tile_h * tile_h) / (2 * var)) / norm
    return np.outer(ys, xs).astype(np.float32)


def tile_offsets(size: int, tile: int, overlap: int) -> List[int]:
    """The reference's grid walk: offset r·(tile - overlap), the last tile
    clamped to the border, duplicates dropped."""
    if size <= tile:
        return [0]
    stride = tile - overlap
    n = 0
    cur = 0
    while cur < size:
        cur = n * stride + tile
        n += 1
    out: List[int] = []
    for o in (min(r * stride, size - tile) for r in range(n)):
        if o not in out:
            out.append(o)
    return out


def make_tiled_denoise_fn(structcond_apply: Callable, unet_apply: Callable,
                          struct_latent: torch.Tensor, context: torch.Tensor,
                          tile: int = 64, overlap: int = 32, batch_tiles: int = 4) -> Callable:
    """A denoise function ``(x, t_orig) -> eps`` for
    :func:`mgldvsr_tpu_torch.core.diffusion.sample_video` whose eps is the
    gaussian-stitched combination of per-tile evaluations.

    ``struct_latent`` is the [(b t), H, W, C] LQ latent of the whole canvas;
    ``structcond_apply(s, t)`` and ``unet_apply(x, t, context, s_cond)``
    take NHWC tiles. A canvas smaller than ``tile`` on an axis is one
    whole-canvas tile on that axis; with a single tile the function is the
    plain denoise function. ``batch_tiles`` tiles go through struct-cond and
    the UNet at a time; eps·w and w are summed in float32 and the result is
    their quotient."""
    bt, H, W, C = struct_latent.shape
    tile_h, tile_w = min(tile, H), min(tile, W)
    oys = tile_offsets(H, tile_h, min(overlap, tile_h // 2))
    oxs = tile_offsets(W, tile_w, min(overlap, tile_w // 2))
    tiles = [(oy, ox) for oy in oys for ox in oxs]

    if len(tiles) == 1:
        def simple_fn(x, t_orig):
            return unet_apply(x, t_orig, context, structcond_apply(struct_latent, t_orig))

        return simple_fn

    w2d = torch.from_numpy(gaussian_tile_weights(tile_h, tile_w)).to(struct_latent.device)
    w2d = w2d[None, :, :, None]
    step = max(1, min(batch_tiles, len(tiles)))
    chunks = [tiles[i:i + step] for i in range(0, len(tiles), step)]

    def cut(a, chunk):
        return torch.cat([a[:, oy:oy + tile_h, ox:ox + tile_w] for oy, ox in chunk], 0)

    # the LQ latent does not change between steps: its tiles are cut once
    struct_tiles = [cut(struct_latent, chunk) for chunk in chunks]

    def fn(x, t_orig):
        acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        wacc = torch.zeros((1, H, W, 1), dtype=torch.float32, device=x.device)
        for chunk, ss in zip(chunks, struct_tiles):
            k = len(chunk)
            tt = t_orig.repeat(k)
            eps = unet_apply(cut(x, chunk), tt, context.repeat(k, 1, 1), structcond_apply(ss, tt))
            for i, (oy, ox) in enumerate(chunk):
                acc[:, oy:oy + tile_h, ox:ox + tile_w] += eps[i * bt:(i + 1) * bt] * w2d
                wacc[:, oy:oy + tile_h, ox:ox + tile_w] += w2d
        return acc / wacc

    return fn


class ImageSpliter:
    """Split [T,H,W,C] frames into overlapping patches of one shape (border
    patches clamped inside the frame) and gather them by overlap-averaging.
    Counterpart of the reference's ``ImageSpliterTh``."""

    def __init__(self, shape: Tuple[int, ...], pch_size: int = 960, stride: int = 750):
        t, h, w, c = shape
        self.shape = tuple(shape)
        self.pch_size_h = min(pch_size, h)
        self.pch_size_w = min(pch_size, w)
        overlap_h = self.pch_size_h - min(stride, self.pch_size_h)
        overlap_w = self.pch_size_w - min(stride, self.pch_size_w)
        self.positions = [(oy, ox)
                          for oy in tile_offsets(h, self.pch_size_h, overlap_h)
                          for ox in tile_offsets(w, self.pch_size_w, overlap_w)]

    def split(self, frames: torch.Tensor) -> List[Tuple[torch.Tensor, Tuple[int, int]]]:
        """(patch view, (oy, ox)) for every position."""
        return [(frames[:, oy:oy + self.pch_size_h, ox:ox + self.pch_size_w], (oy, ox))
                for oy, ox in self.positions]

    def gather(self, patches: Sequence[torch.Tensor]) -> torch.Tensor:
        """The float32 overlap-average of ``patches`` (in the order of
        ``positions``), on their device."""
        t, h, w, c = self.shape
        dev = patches[0].device
        acc = torch.zeros((t, h, w, c), dtype=torch.float32, device=dev)
        cnt = torch.zeros((1, h, w, 1), dtype=torch.float32, device=dev)
        for patch, (oy, ox) in zip(patches, self.positions):
            ph, pw = patch.shape[1:3]
            acc[:, oy:oy + ph, ox:ox + pw] += patch.float()
            cnt[:, oy:oy + ph, ox:ox + pw] += 1.0
        return acc / cnt

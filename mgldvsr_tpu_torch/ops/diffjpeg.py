"""Differentiable JPEG, on the device.

Counterpart of ``mgldvsr_tpu/ops/diffjpeg.py``: RGB -> YCbCr, 2x2 chroma
mean, 8x8 block DCT as two matrix products, quantisation by the quality's
factor with the differentiable rounding ``round(x) + (x - round(x))^3``,
and the inverse path. ``rounding=`` takes another rounding (``torch.round``
for a hard JPEG). ``diff_round`` jumps by 0.75 of a step where a
coefficient crosses a half-integer, so a coefficient within rounding of one
can land on either side on two machines.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

# the standard JPEG base quantisation tables
_Y_TABLE = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61],
     [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56],
     [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77],
     [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float32)
_C_TABLE = np.full((8, 8), 99, dtype=np.float32)
_C_TABLE[:4, :4] = np.array(
    [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]).T

# the orthonormal 8x8 DCT-II matrix, times 2 (JPEG's scaling: x4 over two dims)
_k = np.arange(8)
_DCT = np.sqrt(2.0 / 8.0) * np.cos((2 * _k[None, :] + 1) * _k[:, None] * np.pi / 16)
_DCT[0] /= np.sqrt(2.0)
_DCT = _DCT.astype(np.float32) * 2.0

_RGB_TO_YCC = np.array([[0.299, 0.587, 0.114],
                        [-0.168736, -0.331264, 0.5],
                        [0.5, -0.418688, -0.081312]], np.float32)
_YCC_TO_RGB = np.array([[1.0, 0.0, 1.402],
                        [1.0, -0.344136, -0.714136],
                        [1.0, 1.772, 0.0]], np.float32)


def diff_round(x: torch.Tensor) -> torch.Tensor:
    r = torch.round(x)
    return r + (x - r) ** 3


def quality_to_factor(quality) -> torch.Tensor:
    """JPEG's quality (1-100; a number or a tensor) -> the tables' scale."""
    q = torch.as_tensor(quality, dtype=torch.float32)
    return torch.where(q < 50, 5000.0 / q, 200.0 - q * 2) / 100.0


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


def rgb_to_ycbcr(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,3] in [0, 255] -> YCbCr with the chroma offset 128."""
    out = torch.einsum("nhwc,kc->nhwk", x, _const(_RGB_TO_YCC, x))
    return out + x.new_tensor([0.0, 128.0, 128.0])


def ycbcr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    x = x - x.new_tensor([0.0, 128.0, 128.0])
    return torch.einsum("nhwk,ck->nhwc", x, _const(_YCC_TO_RGB, x))


def _to_blocks(ch: torch.Tensor) -> torch.Tensor:
    """[N,H,W] -> [N, H/8·W/8, 8, 8]."""
    n, h, w = ch.shape
    x = ch.reshape(n, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(n, (h // 8) * (w // 8), 8, 8)


def _from_blocks(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    n = blocks.shape[0]
    x = blocks.reshape(n, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(n, h, w)


def _dct2d(blocks: torch.Tensor) -> torch.Tensor:
    d = _const(_DCT, blocks)
    return d @ blocks @ d.T / 4.0


def _idct2d(blocks: torch.Tensor) -> torch.Tensor:
    d = _const(_DCT, blocks)
    return d.T @ (blocks / 4.0) @ d


def jpeg_planes(x01: torch.Tensor) -> List[torch.Tensor]:
    """[N,H,W,3] in [0, 1] -> the three planes JPEG codes, centred on 0: Y
    [N,H,W], then Cb and Cr each the mean of 2x2 pixels [N,H/2,W/2]."""
    n, h, w, _ = x01.shape
    ycc = rgb_to_ycbcr(x01 * 255.0)

    def down(c):
        return c.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4)) - 128.0

    return [ycc[..., 0] - 128.0, down(ycc[..., 1]), down(ycc[..., 2])]


def scaled_coefficients(x01: torch.Tensor, quality) -> List[torch.Tensor]:
    """Each plane's DCT coefficients over its quantisation step, before the
    rounding: [N, blocks, 8, 8] for Y, Cb and Cr."""
    factor = _factor(quality, x01)
    return [_dct2d(_to_blocks(p)) / (_const(t, x01)[None, None] * factor)
            for p, t in zip(jpeg_planes(x01), (_Y_TABLE, _C_TABLE, _C_TABLE))]


def _factor(quality, x01: torch.Tensor) -> torch.Tensor:
    n = x01.shape[0]
    f = quality_to_factor(quality).to(x01.device).reshape(-1)
    return f.expand(n)[:, None, None, None]


def diff_jpeg(x01: torch.Tensor, quality,
              rounding: Callable[[torch.Tensor], torch.Tensor] = diff_round) -> torch.Tensor:
    """JPEG's round trip of [N,H,W,3] images in [0, 1] (H, W multiples of
    16), ``quality`` a number or [N]; the result clipped to [0, 1]."""
    n, h, w, _ = x01.shape
    factor = _factor(quality, x01)
    planes = []
    for plane, table in zip(jpeg_planes(x01), (_Y_TABLE, _C_TABLE, _C_TABLE)):
        q = _const(table, x01)[None, None] * factor
        deq = rounding(_dct2d(_to_blocks(plane)) / q) * q
        planes.append(_from_blocks(_idct2d(deq), *plane.shape[1:]) + 128.0)
    y, cb, cr = planes

    def up(c):  # nearest 2x
        return c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    rgb = ycbcr_to_rgb(torch.stack([y, up(cb), up(cr)], dim=-1)) / 255.0
    return torch.clamp(rgb, 0.0, 1.0)

"""MaskFlownet_S: PWC-style coarse-to-fine optical flow with learned
occlusion masks.

Counterpart of ``mgldvsr_tpu/flow/maskflownet.py`` (basicsr's
``maskflownet_arch``, the alternate flownet of the MGLD configs). The
reference's two CUDA extensions are plain PyTorch here, as they are plain
XLA in the JAX package: mmcv's ``Correlation`` is :func:`local_correlation`
(81 shifted products, each a mean over channels) and the deformable blend,
whose nine taps all take the flow as their offset, is
:func:`~mgldvsr_tpu_torch.ops.dcn.modulated_deform_conv2d` without a mask.

The public helpers and ``MaskFlownetS.forward`` take NHWC tensors, as the
JAX ones do; the module runs NCHW inside, with internal flows in (y, x)
channel order. ``forward(ref, sup)`` returns the (x, y) flow at the input's
size, in pixels. Keys are upstream's (``conv1a.0``, ``conv6_0.0``,
``pred_flow6``, ``upfeat5``, ``deform5``, ``conv5f.0``, ``dc_conv1.0`` ...
``dc_conv7``), the layout ``mgldvsr_tpu/io/ckpt_convert.convert_maskflownet``
reads; ``upfeat*`` hold torch's ConvTranspose2d weights [in, out, 4, 4].
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.ops.dcn import modulated_deform_conv2d
from mgldvsr_tpu_torch.ops.resize import resize2d


def _triangle_up_kernel(w: int) -> np.ndarray:
    c = w // 2
    k = 1.0 - np.abs(c - np.arange(w, dtype=np.float32)) / (c + 1)
    return np.outer(k, k)


def _triangle_down_kernel(w: int) -> np.ndarray:
    k = ((w + 1) - np.abs(w - np.arange(w * 2 + 1, dtype=np.float32))) / (2 * w + 1)
    return np.outer(k, k)


def _upsample_nchw(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Edge pad by one row and column, a transposed conv with the triangle
    kernel (stride ``factor``), then the last row and column cropped."""
    if factor == 1:
        return x
    n, c, h, w = x.shape
    y = F.pad(x.reshape(n * c, 1, h, w), (0, 1, 0, 1), mode="replicate")
    kern = torch.from_numpy(_triangle_up_kernel(factor * 2 - 1)).to(x)[None, None]
    y = F.conv_transpose2d(y, kern, stride=factor, padding=factor - 1)[:, :, :-1, :-1]
    return y.reshape(n, c, y.shape[2], y.shape[3])


def _downsample_nchw(x: torch.Tensor, factor: int) -> torch.Tensor:
    """A strided conv with the triangle kernel, divided by the same conv of
    ones (so borders are normalised)."""
    if factor == 1:
        return x
    n, c, h, w = x.shape
    y = x.reshape(n * c, 1, h, w)
    kern = torch.from_numpy(_triangle_down_kernel(factor // 2)).to(x)[None, None]
    pad = factor // 2
    num = F.conv2d(y, kern, stride=factor, padding=pad)
    den = F.conv2d(torch.ones_like(y), kern, stride=factor, padding=pad)
    out = num / den
    return out.reshape(n, c, out.shape[2], out.shape[3])


def upsample2d(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Triangle-kernel upsample of NHWC images by ``factor``."""
    return _upsample_nchw(img.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


def downsample2d(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Normalised triangle-kernel downsample of NHWC images by ``factor``."""
    return _downsample_nchw(img.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


def _correlation_nchw(f1: torch.Tensor, f2: torch.Tensor, md: int) -> torch.Tensor:
    n, c, h, w = f1.shape
    f2p = F.pad(f2, (md, md, md, md))
    outs = [(f1 * f2p[:, :, dy:dy + h, dx:dx + w]).mean(dim=1)
            for dy in range(2 * md + 1) for dx in range(2 * md + 1)]
    return torch.stack(outs, dim=1)


def local_correlation(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """NHWC cost volume: ``out[..., k] = mean_c f1[y, x, c] * f2[y+dy, x+dx,
    c]`` with ``k = (dy+md)*(2md+1) + (dx+md)``, zeros outside."""
    out = _correlation_nchw(f1.permute(0, 3, 1, 2), f2.permute(0, 3, 1, 2), md)
    return out.permute(0, 2, 3, 1)


def centralize(img1: torch.Tensor, img2: torch.Tensor):
    """Subtract the two NHWC frames' joint per-sample RGB mean."""
    mean = torch.cat([img1, img2], dim=1).mean(dim=(1, 2), keepdim=True)
    return img1 - mean, img2 - mean, mean


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _conv(cin: int, cout: int, stride: int = 1, dilation: int = 1, act: bool = True):
    layers = [nn.Conv2d(cin, cout, 3, stride=stride, padding=dilation, dilation=dilation)]
    if act:
        layers.append(nn.LeakyReLU(0.1))
    return nn.Sequential(*layers)


class _DeformBlend(nn.Module):
    """DeformConv2d(c, c) whose nine taps all take the (y, x) flow."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels, channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, feat: torch.Tensor, flow_yx: torch.Tensor) -> torch.Tensor:
        offset = flow_yx.permute(0, 2, 3, 1).repeat(1, 1, 1, 9)
        out = modulated_deform_conv2d(feat.permute(0, 2, 3, 1), offset, None, self.weight,
                                      self.bias)
        return out.permute(0, 3, 1, 2)


_PYRAMID = (16, 32, 64, 96, 128, 196)
_DENSE = (128, 128, 96, 64, 32)
_CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))


@dataclasses.dataclass(frozen=True)
class MaskFlownetConfig:
    md: int = 4
    scale: float = 20.0
    strides: Sequence[int] = (64, 32, 16, 8, 4)
    upfeat_ch: int = 16


class MaskFlownetS(nn.Module):
    """``forward(ref, sup)`` -> flow [N, H, W, 2] in (x, y) order, pixels;
    frames NHWC."""

    def __init__(self, cfg: MaskFlownetConfig = MaskFlownetConfig()):
        super().__init__()
        self.cfg = cfg
        cin = 3
        for i, ch in enumerate(_PYRAMID, start=1):
            setattr(self, f"conv{i}a", _conv(cin, ch, stride=2))
            setattr(self, f"conv{i}b", _conv(ch, ch))
            setattr(self, f"conv{i}c", _conv(ch, ch))
            cin = ch
        corr = (2 * cfg.md + 1) ** 2
        width = self._head(6, corr)
        self.pred_flow6 = nn.Conv2d(width, 2, 3, padding=1)
        self.pred_mask6 = nn.Conv2d(width, 1, 3, padding=1)
        for k in (5, 4, 3, 2):  # the reference's level k, the pyramid's index k - 1
            ch = _PYRAMID[k - 1]
            setattr(self, f"upfeat{k}", nn.ConvTranspose2d(width, cfg.upfeat_ch, 4, 2, 1))
            setattr(self, f"deform{k}", _DeformBlend(ch))
            setattr(self, f"conv{k}f", _conv(cfg.upfeat_ch, ch, act=False))
            width = self._head(k, corr + ch + cfg.upfeat_ch + 2)
            setattr(self, f"pred_flow{k}", nn.Conv2d(width, 2, 3, padding=1))
            if k != 2:
                setattr(self, f"pred_mask{k}", nn.Conv2d(width, 1, 3, padding=1))
        for i, (ch, dil) in enumerate(_CONTEXT, start=1):
            setattr(self, f"dc_conv{i}", _conv(width, ch, dilation=dil))
            width = ch
        self.dc_conv7 = nn.Conv2d(width, 2, 3, padding=1)

    def _head(self, level: int, cin: int) -> int:
        for j, ch in enumerate(_DENSE):
            setattr(self, f"conv{level}_{j}", _conv(cin, ch))
            cin += ch
        return cin

    def _dense(self, level: int, x: torch.Tensor) -> torch.Tensor:
        for j in range(len(_DENSE)):
            x = torch.cat([getattr(self, f"conv{level}_{j}")(x), x], dim=1)
        return x

    def forward(self, ref: torch.Tensor, sup: torch.Tensor) -> torch.Tensor:
        ref, sup, _ = centralize(ref, sup)
        h, w = ref.shape[1], ref.shape[2]
        h64, w64 = -(-h // 64) * 64, -(-w // 64) * 64
        ref = resize2d(ref, (h64, w64), method="bilinear").permute(0, 3, 1, 2)
        sup = resize2d(sup, (h64, w64), method="bilinear").permute(0, 3, 1, 2)
        flow = _upsample_nchw(self._process(ref, sup), 4).permute(0, 2, 3, 1)
        flow = resize2d(flow, (h, w), method="bilinear")
        fy = flow[..., 0] * (float(h) / float(h64))
        fx = flow[..., 1] * (float(w) / float(w64))
        return torch.stack([fx, fy], dim=-1).float() * self.cfg.scale

    def _process(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        """The coarse-to-fine decode on NCHW frames; the finest internal
        flow (1/4 of the size) in (y, x) order."""
        cfg = self.cfg
        x = torch.cat([im1, im2], dim=0)  # one pass of the shared pyramid
        feats = []
        for i in range(1, len(_PYRAMID) + 1):
            for s in "abc":
                x = getattr(self, f"conv{i}{s}")(x)
            feats.append(x)
        n = im1.shape[0]
        c1 = [f[:n] for f in feats]
        c2 = [f[n:] for f in feats]

        x = self._dense(6, _lrelu(_correlation_nchw(c1[5], c2[5], cfg.md)))
        flow = self.pred_flow6(x)
        mask = self.pred_mask6(x)
        for step, k in enumerate((5, 4, 3, 2)):
            lvl = k - 1
            stride = cfg.strides[step + 1]
            feat = _lrelu(getattr(self, f"upfeat{k}")(x))
            flow = _upsample_nchw(flow, 2)
            mask = _upsample_nchw(mask, 2)
            warped = getattr(self, f"deform{k}")(c2[lvl], flow * (cfg.scale / stride))
            tradeoff = getattr(self, f"conv{k}f")(feat)
            warped = _lrelu(warped * torch.sigmoid(mask) + tradeoff)
            corr = _lrelu(_correlation_nchw(c1[lvl], warped, cfg.md))
            x = self._dense(k, torch.cat([corr, c1[lvl], feat, flow], dim=1))
            flow = flow + getattr(self, f"pred_flow{k}")(x)
            if k != 2:
                mask = getattr(self, f"pred_mask{k}")(x)
        y = x
        for i in range(1, len(_CONTEXT) + 1):
            y = getattr(self, f"dc_conv{i}")(y)
        return flow + self.dc_conv7(y)

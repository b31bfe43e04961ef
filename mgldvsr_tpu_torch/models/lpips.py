"""LPIPS perceptual distance: VGG16 features and learned linear heads.

Counterpart of ``mgldvsr_tpu/models/lpips.py`` (the ``taming`` LPIPS of the
stage-2 VAE loss). Inputs in [-1, 1] are shifted and scaled, VGG16's
relu1_2 ... relu5_3 activations are normalised over channels, their squared
differences go through 1x1 heads without bias, and the heads' spatial means
are summed over the five taps: one distance an image.

Keys are taming's: the VGG convs under ``net.slice{s}.{idx}`` (torchvision's
``features`` indices) and the heads under ``lin{i}.model.1``, the layout
``mgldvsr_tpu/io/ckpt_convert.convert_lpips`` reads. The shift and scale
are constants, not state. LPIPS is frozen and runs in float32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

# taming/lpips normalisation constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision VGG16 ``features``: each slice's (first index, [conv indices],
# channels); a slice opens with the max-pool at its first index (but the first)
_VGG_SLICES = (
    (0, (0, 2), 64),
    (4, (5, 7), 128),
    (9, (10, 12, 14), 256),
    (16, (17, 19, 21), 512),
    (23, (24, 26, 28), 512),
)


class _Slice(nn.Module):
    """One taming ``slice``: children named by torchvision's indices, convs
    (3x3, padding 1) each followed by a ReLU."""

    def __init__(self, first: int, convs, cin: int, cout: int):
        super().__init__()
        self.pool = first != 0
        self.convs = list(convs)
        for idx in convs:
            self.add_module(str(idx), nn.Conv2d(cin, cout, 3, padding=1))
            cin = cout

    def forward(self, x):
        if self.pool:
            x = F.max_pool2d(x, 2, 2)
        for idx in self.convs:
            x = F.relu(getattr(self, str(idx))(x))
        return x


class VGG16Features(nn.Module):
    """The five LPIPS taps of VGG16 (relu1_2, relu2_2, relu3_3, relu4_3,
    relu5_3)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for s, (first, convs, ch) in enumerate(_VGG_SLICES):
            self.add_module(f"slice{s + 1}", _Slice(first, convs, cin, ch))
            cin = ch

    def forward(self, x):
        taps = []
        for s in range(len(_VGG_SLICES)):
            x = getattr(self, f"slice{s + 1}")(x)
            taps.append(x)
        return taps


class _NetLin(nn.Module):
    """taming's NetLinLayer: dropout (0 in eval) then a 1x1 conv without bias
    (key ``model.1``)."""

    def __init__(self, cin: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(0.0), nn.Conv2d(cin, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


def normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """x over its channel norm, ``eps`` added outside the square root."""
    return x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """``lpips(a, b)`` -> [N] perceptual distances of NCHW images in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for i, (_, _, ch) in enumerate(_VGG_SLICES):
            self.add_module(f"lin{i}", _NetLin(ch))
        self.requires_grad_(False)
        self.eval()

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(_SHIFT, dtype=torch.float32, device=a.device)[None, :, None, None]
        scale = torch.tensor(_SCALE, dtype=torch.float32, device=a.device)[None, :, None, None]
        fa = self.net((a.float() - shift) / scale)
        fb = self.net((b.float() - shift) / scale)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            d = (normalize_tensor(xa) - normalize_tensor(xb)) ** 2
            total = total + getattr(self, f"lin{i}")(d).mean(dim=(1, 2, 3))
        return total

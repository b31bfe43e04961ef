"""FID's InceptionV3 pool3 feature tower.

Counterpart of ``mgldvsr_tpu/metrics/inception.py`` (the pytorch-fid port
of TensorFlow's inception-2015-12-05 network that basicsr's
``archs/inception.py`` ships): torchvision's Inception-v3 topology with the
FID patches, i.e. ``count_include_pad=False`` average pools in the A, C and
E branch pools and a max pool in the last E block (Mixed_7c), ending in the
2048-dim global average pool.

The blocks compute in NCHW; :class:`InceptionV3FID` takes [N, H, W, 3]
frames, as the JAX module does, and returns [N, 2048]. Parameter names are
the pt_inception-2015-12-05 checkpoint's (``Conv2d_1a_3x3.conv.weight``,
``….bn.{weight,bias,running_mean,running_var}``), so that checkpoint loads
with ``load_state_dict(strict=True)`` once its ``fc.*``, ``AuxLogits.*`` and
``num_batches_tracked`` entries are dropped (:func:`feature_state_dict`).
The network has no TPU kernel behind it: its convolutions are the
library's.
"""
from __future__ import annotations

from typing import Mapping, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.flow.raft import FrozenBatchNorm
from mgldvsr_tpu_torch.ops.resize import resize2d

Pad = Union[int, Tuple[int, int]]


class BasicConv(nn.Module):
    """Conv without bias, frozen BatchNorm (eps 1e-3), ReLU: BasicConv2d."""

    def __init__(self, cin: int, cout: int, kernel: Pad = 1, stride: int = 1, padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = FrozenBatchNorm(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg3_nopad_count(x):
    """3x3 stride-1 average pool, zero padding 1, ``count_include_pad=False``."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class FIDInceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64)
        self.branch5x5_1 = BasicConv(cin, 48)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg3_nopad_count(x))
        return torch.cat([self.branch1x1(x), b5, bd, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max3s2(x)], dim=1)


class FIDInceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv(cin, 192)
        self.branch7x7_1 = BasicConv(cin, c7)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg3_nopad_count(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max3s2(x)], dim=1)


class FIDInceptionE(nn.Module):
    """InceptionE with the FID branch-pool patch; ``use_max_pool`` is the
    Mixed_7c variant (a max pool where the others average)."""

    def __init__(self, cin: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool
        self.branch1x1 = BasicConv(cin, 320)
        self.branch3x3_1 = BasicConv(cin, 384)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.use_max_pool:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg3_nopad_count(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3FID(nn.Module):
    """Pool3 (2048-dim) FID features of [N, H, W, 3] frames.

    ``resize_input`` resizes bilinearly to 299x299 (align_corners=False, the
    port's ``resize2d``, as JAX does); ``normalize_input`` maps [0,1] to
    [-1,1]. The network itself expects [-1,1] (basicsr's
    ``inception.py:125-143``): with ``normalize_input=False`` the caller
    scales."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = False):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = FIDInceptionA(192, 32)
        self.Mixed_5c = FIDInceptionA(256, 64)
        self.Mixed_5d = FIDInceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = FIDInceptionC(768, 128)
        self.Mixed_6c = FIDInceptionC(768, 160)
        self.Mixed_6d = FIDInceptionC(768, 160)
        self.Mixed_6e = FIDInceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = FIDInceptionE(1280)
        self.Mixed_7c = FIDInceptionE(2048, use_max_pool=True)
        self.requires_grad_(False)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.resize_input:
            x = resize2d(x, (299, 299), method="bilinear")
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max3s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return torch.mean(x, dim=(2, 3))


def feature_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """A pt_inception state dict less what the pool3 tower does not hold:
    the 1008-class ``fc.*`` head, ``AuxLogits.*`` and BatchNorm's
    ``num_batches_tracked`` (as ``convert_inception`` skips them)."""
    return {k: v for k, v in sd.items()
            if not k.startswith(("fc.", "AuxLogits.")) and not k.endswith("num_batches_tracked")}

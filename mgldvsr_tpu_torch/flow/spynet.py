"""SpyNet coarse-to-fine optical flow (the stage-2 training loss's flownet).

Counterpart of ``mgldvsr_tpu/flow/spynet.py`` (basicsr's ``spynet_arch``):
frames are resized bilinearly to multiples of 32, ImageNet-normalised and
pooled into a 6-level pyramid; from zeros at the coarsest level, each level
upsamples the flow x2 (``align_corners=True``), warps the support frame by
it with border padding, and adds the output of a 5-conv (7x7) module over
[ref, warped, flow]. The flow is resized back and rescaled. Frames are
NHWC in [0, 1] as in the JAX package; the convs run in NCHW.

Keys are basicsr's ``basic_module.{i}.basic_module.{2j}``, the layout
``mgldvsr_tpu/io/ckpt_convert.convert_spynet`` reads. The warp is the
port's plain ``ops/warp.flow_warp``: the CUDA warp kernel pads with zeros
only.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.ops.resize import resize2d
from mgldvsr_tpu_torch.ops.warp import flow_warp

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class BasicModule(nn.Module):
    """conv(8->32) ReLU conv(->64) ReLU conv(->32) ReLU conv(->16) ReLU
    conv(->2), all 7x7 (key ``basic_module.{0,2,4,6,8}``)."""

    def __init__(self):
        super().__init__()
        chans = (8, 32, 64, 32, 16, 2)
        layers = []
        for i in range(5):
            layers.append(nn.Conv2d(chans[i], chans[i + 1], 7, padding=3))
            if i < 4:
                layers.append(nn.ReLU())
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x):
        return self.basic_module(x)


class SpyNet(nn.Module):
    """``spynet(ref, supp)`` -> flow [N, H, W, 2] of NHWC frames in [0, 1]."""

    def __init__(self, levels: int = 6):
        super().__init__()
        self.levels = levels
        self.basic_module = nn.ModuleList([BasicModule() for _ in range(levels)])
        self.requires_grad_(False)
        self.eval()

    def forward(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = ref.shape
        h32, w32 = -(-h // 32) * 32, -(-w // 32) * 32
        mean = torch.tensor(_MEAN, dtype=torch.float32, device=ref.device)
        std = torch.tensor(_STD, dtype=torch.float32, device=ref.device)

        def pyramid(x):
            x = (resize2d(x.float(), (h32, w32), method="bilinear") - mean) / std
            pyr = [x.permute(0, 3, 1, 2)]
            for _ in range(self.levels - 1):
                pyr.insert(0, F.avg_pool2d(pyr[0], 2, 2))
            return [p.permute(0, 2, 3, 1) for p in pyr]

        ref_pyr, supp_pyr = pyramid(ref), pyramid(supp)
        h0, w0 = ref_pyr[0].shape[1:3]
        # at least 1 so that tiny inputs do not give an empty start
        flow = ref.new_zeros((n, max(h0 // 2, 1), max(w0 // 2, 1), 2), dtype=torch.float32)
        for level in range(self.levels):
            hl, wl = ref_pyr[level].shape[1:3]
            up = 2.0 * resize2d(flow, (hl, wl), method="bilinear", align_corners=True)
            warped = flow_warp(supp_pyr[level], up, padding_mode="border")
            inp = torch.cat([ref_pyr[level], warped, up], dim=-1).permute(0, 3, 1, 2)
            flow = self.basic_module[level](inp).permute(0, 2, 3, 1) + up
        flow = resize2d(flow, (h, w), method="bilinear")
        scale = torch.tensor([w / w32, h / h32], dtype=torch.float32, device=ref.device)
        return flow * scale

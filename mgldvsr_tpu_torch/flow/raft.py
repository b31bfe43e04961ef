"""RAFT optical flow ('normal' variant: instance-norm fnet, frozen-BN cnet).

Counterpart of ``mgldvsr_tpu/flow/raft.py`` with raft-things.pth's
state-dict keys. Frames go in as NHWC [N,H,W,3] in [0,1] and the flow comes
out NHWC [N,H,W,2]; inside, the nets are NCHW. The correlation lookup of
every iteration goes to the hand-written kernel
(:func:`mgldvsr_tpu_torch.ops.kernels.corr_lookup.lookup_corr`).
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.models.layers import Conv2d
from mgldvsr_tpu_torch.ops.kernels.corr_lookup import lookup_corr


def _conv(cin: int, cout: int, k, stride: int = 1) -> Conv2d:
    """Conv with torch's symmetric k//2 padding."""
    k = k if isinstance(k, tuple) else (k, k)
    return Conv2d(cin, cout, k, stride=stride, padding=(k[0] // 2, k[1] // 2))


class FrozenBatchNorm(nn.Module):
    """Inference batch norm: weight*(x - running_mean)/sqrt(running_var+eps)
    + bias, with BatchNorm2d's parameter and buffer names."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


def _norm(kind: str, features: int) -> nn.Module:
    return FrozenBatchNorm(features) if kind == "batch" else InstanceNorm()


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm_fn: str, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.conv2 = _conv(planes, planes, 3)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(_conv(cin, planes, 1, stride),
                                            _norm(norm_fn, planes))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """7x7 stride-2 stem + three 2-block residual stages + 1x1 head."""

    def __init__(self, output_dim: int, norm_fn: str):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.norm1 = _norm(norm_fn, 64)
        cin = 64
        for i, (dim, stride) in enumerate([(64, 1), (96, 2), (128, 2)]):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                ResidualBlock(cin, dim, norm_fn, stride), ResidualBlock(dim, dim, norm_fn)))
            cin = dim
        self.conv2 = _conv(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> List[torch.Tensor]:
    """All-pairs correlation of [B,C,H,W] maps, then 2x average pooling over
    the target dims with odd sizes floor-truncated. Level l is
    [B, H*W, H/2^l, W/2^l] float32."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.reshape(b, c, h * w).float()
    f2 = fmap2.reshape(b, c, h * w).float()
    corr = torch.einsum("bcn,bcm->bnm", f1, f2) / torch.sqrt(torch.tensor(
        float(c), device=fmap1.device))
    corr = corr.reshape(b, h * w, h, w)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        bl, n, hl, wl = corr.shape
        # written out rather than avg_pool2d, which refuses empty levels
        corr = corr[:, :, :hl // 2 * 2, :wl // 2 * 2]
        corr = corr.reshape(bl, n, hl // 2, 2, wl // 2, 2).mean(dim=(3, 5))
        pyramid.append(corr)
    return pyramid


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = _conv(corr_planes, 256, 1)
        self.convc2 = _conv(256, 192, 3)
        self.convf1 = _conv(2, 128, 7)
        self.convf2 = _conv(128, 64, 3)
        self.conv = _conv(64 + 192, 126, 3)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz1 = _conv(c, hidden_dim, (1, 5))
        self.convr1 = _conv(c, hidden_dim, (1, 5))
        self.convq1 = _conv(c, hidden_dim, (1, 5))
        self.convz2 = _conv(c, hidden_dim, (5, 1))
        self.convr2 = _conv(c, hidden_dim, (5, 1))
        self.convq2 = _conv(c, hidden_dim, (5, 1))

    def forward(self, h, x):
        for cz, cr, cq in ((self.convz1, self.convr1, self.convq1),
                           (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(cz(hx))
            r = torch.sigmoid(cr(hx))
            q = torch.tanh(cq(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class _FlowHead(nn.Module):
    def __init__(self, hidden_dim: int):
        super().__init__()
        self.conv1 = _conv(hidden_dim, 256, 3)
        self.conv2 = _conv(256, 2, 3)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_planes: int, hidden_dim: int = 128, context_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden_dim, context_dim + 128)
        self.flow_head = _FlowHead(hidden_dim)
        self.mask = nn.Sequential(_conv(hidden_dim, 256, 3), nn.ReLU(), _conv(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def convex_upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Learned 8x upsampling: per output pixel a softmax-convex combination
    of the coarse 3x3 neighbourhood. flow [N,2,H,W], mask [N,576,H,W]."""
    n, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(n, 9, 8, 8, h, w), dim=1)
    patches = F.unfold(8.0 * flow, 3, padding=1).reshape(n, 2, 9, h, w)
    up = torch.einsum("nkijhw,nckhw->nchiwj", m, patches)
    return up.reshape(n, 2, 8 * h, 8 * w)


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 10
    # the JAX package's lookup switch ("xla" / "pallas" choose a plain or a
    # TPU path); here the lookup is the corr_lookup kernel on the card and
    # its plain version on the CPU, so only "auto" is taken
    lookup_impl: str = "auto"

    def __post_init__(self):
        if self.lookup_impl != "auto":
            raise ValueError(
                f"RAFTConfig.lookup_impl={self.lookup_impl!r}: only 'auto' is taken. The "
                f"correlation lookup is the corr_lookup CUDA kernel on the card and its "
                f"plain version on the CPU; the JAX package's 'xla' and 'pallas' paths "
                f"(a plain path or a TPU kernel on the card) are not ported")


class RAFT(nn.Module):
    """flow = RAFT(ref, supp): [N,H,W,3] in [0,1] -> [N,H,W,2] mapping supp
    to ref sampling positions (``flow_warp(supp, flow) ~ ref``)."""

    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch")
        corr_planes = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.update_block = BasicUpdateBlock(corr_planes, cfg.hidden_dim, cfg.context_dim)

    def forward(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n, h, w, _ = ref.shape
        pad_h, pad_w = (8 - h % 8) % 8, (8 - w % 8) % 8
        pt, plft = pad_h // 2, pad_w // 2
        pads = (plft, pad_w - plft, pt, pad_h - pt)
        ref = ref.permute(0, 3, 1, 2).float()
        supp = supp.permute(0, 3, 1, 2).float()
        if pad_h or pad_w:
            ref = F.pad(ref, pads, mode="replicate")
            supp = F.pad(supp, pads, mode="replicate")
        both = self.fnet(torch.cat([ref, supp], dim=0)).float()
        pyramid = [lvl.contiguous() for lvl in
                   build_corr_pyramid(both[:n], both[n:], cfg.corr_levels)]
        ctx = self.cnet(ref)
        net = torch.tanh(ctx[:, :cfg.hidden_dim])
        inp = torch.relu(ctx[:, cfg.hidden_dim:])

        h8, w8 = ref.shape[2] // 8, ref.shape[3] // 8
        gy, gx = torch.meshgrid(torch.arange(h8, dtype=torch.float32, device=ref.device),
                                torch.arange(w8, dtype=torch.float32, device=ref.device),
                                indexing="ij")
        coords0 = torch.stack([gx, gy], dim=-1)[None].expand(n, h8, w8, 2)  # NHWC (x, y)
        coords1 = coords0.clone()
        mask = None
        for _ in range(cfg.iters):
            corr = lookup_corr(pyramid, coords1.contiguous(), cfg.corr_radius)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            net, mask, dflow = self.update_block(net, inp, corr.permute(0, 3, 1, 2), flow)
            coords1 = coords1 + dflow.permute(0, 2, 3, 1)
        flow_up = convex_upsample_flow((coords1 - coords0).permute(0, 3, 1, 2), mask)
        return flow_up[:, :, pt:pt + h, plft:plft + w].permute(0, 2, 3, 1)

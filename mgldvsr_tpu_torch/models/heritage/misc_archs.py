"""The remaining BasicSR-heritage architectures: RCAN, TOFlow with its
SPyNet, DUF, ECBSR, RIDNet and the DEResNet degradation estimator.

Counterpart of ``mgldvsr_tpu/models/heritage/misc_archs.py``. Images are
NHWC at the boundary ([B, T, H, W, C] for the video models), as in JAX;
convs run NCHW (NCDHW for DUF's 3-D convs) inside. Keys are basicsr's, the
layout the JAX package's converters read. Batch norms are frozen
(``_FrozenBN``: ``weight`` / ``bias`` / ``running_mean`` / ``running_var``,
the JAX arithmetic). ECBSR keeps the reference's training-form branches
and folds them into one 3x3 conv a block at every call, as the reference's
deploy form does (the converter's fold, in torch). RIDNet's MeanShift is a
division by the std (``sub_mean`` / ``add_mean`` are stored as the
reference's constants and not read).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.models.heritage.sr_archs import (
    RCAB,
    PReLU,
    ResidualBlockNoBN,
    ChannelAttention,
    conv,
    nchw,
    nhwc,
    pixel_shuffle,
)
from mgldvsr_tpu_torch.models.heritage.video_archs import warp_nchw
from mgldvsr_tpu_torch.ops.resize import resize2d

_RGB_MEAN = (0.4488, 0.4371, 0.4040)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _upsampler(num_feat: int, upscale: int) -> nn.Sequential:
    layers, up = [], upscale
    while up > 1:
        r = 3 if up % 3 == 0 else 2
        layers += [conv(num_feat, num_feat * r * r), nn.PixelShuffle(r)]
        up //= r
    return nn.Sequential(*layers)


class ResidualGroup(nn.Module):
    def __init__(self, num_feat: int, num_block: int, squeeze_factor: int = 16):
        super().__init__()
        self.residual_group = nn.Sequential(*[RCAB(num_feat, squeeze_factor)
                                              for _ in range(num_block)])
        self.conv = conv(num_feat, num_feat)

    def forward(self, x):
        return x + self.conv(self.residual_group(x))


class RCAN(nn.Module):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_group: int = 10, num_block: int = 16, squeeze_factor: int = 16,
                 upscale: int = 4, img_range: float = 255.0):
        super().__init__()
        self.img_range = img_range
        self.conv_first = conv(num_in_ch, num_feat)
        self.body = nn.Sequential(*[ResidualGroup(num_feat, num_block, squeeze_factor)
                                    for _ in range(num_group)])
        self.conv_after_body = conv(num_feat, num_feat)
        self.upsample = _upsampler(num_feat, upscale)
        self.conv_last = conv(num_feat, num_out_ch)

    def forward(self, x):
        mean = torch.tensor(_RGB_MEAN, dtype=x.dtype, device=x.device)
        feat = self.conv_first(nchw((x - mean) * self.img_range))
        feat = feat + self.conv_after_body(self.body(feat))
        out = nhwc(self.conv_last(self.upsample(feat)))
        return out / self.img_range + mean


class _FrozenBN(nn.Module):
    """Inference batch norm over axis 1 (NCHW or NCDHW)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return x * inv.view(shape) + (self.bias - self.running_mean * inv).view(shape)


class TOFBasicModule(nn.Module):
    """4x (7x7 conv without bias, batch norm, ReLU), then a 7x7 conv to the
    2 flow channels (keys ``basic_module.{0,1,3,4,...,12}``)."""

    def __init__(self):
        super().__init__()
        chans = (8, 32, 64, 32, 16)
        layers: List[nn.Module] = []
        for i in range(4):
            layers += [nn.Conv2d(chans[i], chans[i + 1], 7, padding=3, bias=False),
                       _FrozenBN(chans[i + 1]), nn.ReLU()]
        layers.append(nn.Conv2d(16, 2, 7, padding=3))
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x):
        return self.basic_module(x)


class SPyNetTOF(nn.Module):
    """TOFlow's 4-level coarse-to-fine flow on normalised NHWC frames."""

    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList([TOFBasicModule() for _ in range(4)])

    def forward(self, ref, supp):
        b, h, w, _ = ref.shape
        refs, supps = [nchw(ref)], [nchw(supp)]
        for _ in range(3):
            refs.insert(0, F.avg_pool2d(refs[0], 2, 2))
            supps.insert(0, F.avg_pool2d(supps[0], 2, 2))
        flow = ref.new_zeros((b, h // 16, w // 16, 2))
        for i in range(4):
            hh, ww = refs[i].shape[2:]
            flow_up = 2.0 * resize2d(flow, (hh, ww), "bilinear", align_corners=True)
            inp = torch.cat([refs[i], warp_nchw(supps[i], flow_up), nchw(flow_up)], 1)
            flow = flow_up + nhwc(self.basic_module[i](inp))
        return flow


class TOFlow(nn.Module):
    """``forward(lrs [B,7,H,W,3])`` -> [B,H,W,3]: SPyNet aligns the six
    neighbours to the reference frame, then a 7-frame reconstruction."""

    def __init__(self, adapt_official_weights: bool = False):
        super().__init__()
        self.adapt_official_weights = adapt_official_weights
        self.spynet = SPyNetTOF()
        self.conv_1 = conv(3 * 7, 64, 9)
        self.conv_2 = conv(64, 64, 9)
        self.conv_3 = conv(64, 64, 1)
        self.conv_4 = conv(64, 3, 1)

    def forward(self, lrs):
        ref_idx = 0 if self.adapt_official_weights else 3
        if self.adapt_official_weights:
            lrs = lrs[:, [3, 0, 1, 2, 4, 5, 6]]
        mean = torch.tensor(IMAGENET_MEAN, dtype=lrs.dtype, device=lrs.device)
        std = torch.tensor(IMAGENET_STD, dtype=lrs.dtype, device=lrs.device)
        lrs = (lrs - mean) / std
        lr_ref = lrs[:, ref_idx]
        aligned = []
        for i in range(7):
            if i == ref_idx:
                aligned.append(nchw(lr_ref))
            else:
                aligned.append(warp_nchw(nchw(lrs[:, i]), self.spynet(lr_ref, lrs[:, i])))
        hr = F.relu(self.conv_1(torch.cat(aligned, 1)))
        hr = F.relu(self.conv_3(F.relu(self.conv_2(hr))))
        hr = nhwc(self.conv_4(hr)) + lr_ref
        return hr * std + mean


def _dense_unit(cin: int, grow: int, t_pad: bool) -> nn.Sequential:
    """BN-ReLU-conv1x1x1-BN-ReLU-conv3x3x3 (time padded by 1, or cropped)."""
    return nn.Sequential(
        _FrozenBN(cin), nn.ReLU(), nn.Conv3d(cin, cin, 1), _FrozenBN(cin), nn.ReLU(),
        nn.Conv3d(cin, grow, 3, padding=(1 if t_pad else 0, 1, 1)))


class _DenseBlocks(nn.Module):
    def __init__(self, ch: int, grow: int, num_block: int):
        super().__init__()
        self.dense_blocks = nn.ModuleList([_dense_unit(ch + i * grow, grow, True)
                                           for i in range(num_block)])


class _TemporalReduce(nn.Module):
    def __init__(self, ch: int, grow: int):
        super().__init__()
        for i in range(3):
            setattr(self, f"temporal_reduce{i + 1}", _dense_unit(ch + i * grow, grow, False))


class DUF(nn.Module):
    """``forward(x [B,7,H,W,3])`` -> [B, sH, sW, 3]: a 3-D dense trunk
    predicts per-pixel 5x5 upsampling filters (a softmax over the 25 taps,
    applied to the centre frame as an einsum) and a residual."""

    def __init__(self, scale: int = 4, num_layer: int = 52):
        super().__init__()
        self.scale = scale
        self.num_block, grow = {16: (3, 32), 28: (9, 16), 52: (21, 16)}[num_layer]
        self.conv3d1 = nn.Conv3d(3, 64, (1, 3, 3), padding=(0, 1, 1))
        self.dense_block1 = _DenseBlocks(64, grow, self.num_block)
        ch = 64 + self.num_block * grow
        self.dense_block2 = _TemporalReduce(ch, grow)
        ch += 3 * grow
        self.bn3d2 = _FrozenBN(ch)
        self.conv3d2 = nn.Conv3d(ch, 256, (1, 3, 3), padding=(0, 1, 1))
        self.conv3d_r1 = nn.Conv3d(256, 256, 1)
        self.conv3d_r2 = nn.Conv3d(256, 3 * scale ** 2, 1)
        self.conv3d_f1 = nn.Conv3d(256, 512, 1)
        self.conv3d_f2 = nn.Conv3d(512, 25 * scale ** 2, 1)

    def forward(self, x):
        b, t, h, w, _ = x.shape
        s2 = self.scale ** 2
        x_center = x[:, t // 2]
        feat = self.conv3d1(x.permute(0, 4, 1, 2, 3))
        for unit in self.dense_block1.dense_blocks:
            feat = torch.cat([feat, unit(feat)], 1)
        for i in range(3):
            y = getattr(self.dense_block2, f"temporal_reduce{i + 1}")(feat)
            feat = torch.cat([feat[:, :, 1:-1], y], 1)
        feat = F.relu(self.conv3d2(F.relu(self.bn3d2(feat))))
        res = self.conv3d_r2(F.relu(self.conv3d_r1(feat)))[:, :, 0].permute(0, 2, 3, 1)
        filt = self.conv3d_f2(F.relu(self.conv3d_f1(feat)))[:, :, 0].permute(0, 2, 3, 1)
        filt = torch.softmax(filt.reshape(b, h, w, 25, s2), dim=3)
        cp = F.pad(x_center, (0, 0, 2, 2, 2, 2))
        patches = torch.stack([cp[:, dy:dy + h, dx:dx + w, :] for dy in range(5)
                               for dx in range(5)], dim=-1)  # [B,H,W,3,25]
        out = torch.einsum("bhwck,bhwkr->bhwcr", patches, filt).reshape(b, h, w, 3 * s2)
        return pixel_shuffle(out + res, self.scale)


EDGE_KINDS = ("sbx", "sby", "lpl")
ECB_DEPTH_MULTIPLIER = 2  # ECBSR's: the 1x1 -> 3x3 branch's middle width over its output


def edge_mask(kind: str, cout: int) -> torch.Tensor:
    """The fixed [cout, 1, 3, 3] Sobel-x, Sobel-y or Laplacian taps of an
    ECB's edge branch."""
    taps = {"sbx": {(0, 0): 1, (1, 0): 2, (2, 0): 1, (0, 2): -1, (1, 2): -2, (2, 2): -1},
            "sby": {(0, 0): 1, (0, 1): 2, (0, 2): 1, (2, 0): -1, (2, 1): -2, (2, 2): -1},
            "lpl": {(0, 1): 1, (1, 0): 1, (1, 2): 1, (2, 1): 1, (1, 1): -4}}[kind]
    m = torch.zeros(cout, 1, 3, 3)
    for (i, j), v in taps.items():
        m[:, 0, i, j] = v
    return m


class _Conv1x1Conv3x3(nn.Module):
    def __init__(self, cin: int, cout: int, mid: int):
        super().__init__()
        self.k0 = nn.Parameter(torch.zeros(mid, cin, 1, 1))
        self.b0 = nn.Parameter(torch.zeros(mid))
        self.k1 = nn.Parameter(torch.zeros(cout, mid, 3, 3))
        self.b1 = nn.Parameter(torch.zeros(cout))


class _EdgeConv(nn.Module):
    """A 1x1 conv then a fixed Sobel or Laplacian 3x3 scaled a channel."""

    def __init__(self, kind: str, cin: int, cout: int):
        super().__init__()
        self.k0 = nn.Parameter(torch.zeros(cout, cin, 1, 1))
        self.b0 = nn.Parameter(torch.zeros(cout))
        self.scale = nn.Parameter(torch.zeros(cout, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.mask = nn.Parameter(edge_mask(kind, cout), requires_grad=False)


class ECB(nn.Module):
    """Edge-oriented conv block: the five training branches folded into
    one 3x3 conv at every call, then PReLU (``act_type="prelu"``) or
    nothing (``"linear"``)."""

    def __init__(self, cin: int, cout: int, act_type: str = "prelu", with_idt: bool = False):
        super().__init__()
        self.with_idt = with_idt and cin == cout
        self.conv3x3 = nn.Conv2d(cin, cout, 3, padding=1)
        self.conv1x1_3x3 = _Conv1x1Conv3x3(cin, cout, ECB_DEPTH_MULTIPLIER * cout)
        for kind in EDGE_KINDS:
            setattr(self, f"conv1x1_{kind}", _EdgeConv(kind, cin, cout))
        self.act = PReLU(cout) if act_type == "prelu" else None

    def rep_params(self):
        """The deploy conv's (weight, bias): the converter's fold."""
        w = self.conv3x3.weight
        b = self.conv3x3.bias
        c = self.conv1x1_3x3
        w = w + torch.einsum("omhw,mi->oihw", c.k1, c.k0[:, :, 0, 0])
        b = b + (c.b1 + torch.einsum("m,omhw->o", c.b0, c.k1))
        for e in (getattr(self, f"conv1x1_{kind}") for kind in EDGE_KINDS):
            tmp = (e.scale * e.mask)[:, 0]
            w = w + torch.einsum("ohw,oi->oihw", tmp, e.k0[:, :, 0, 0])
            b = b + (e.bias + e.b0 * tmp.sum(dim=(1, 2)))
        if self.with_idt:
            eye = torch.zeros_like(w)
            eye[:, :, 1, 1] = torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
            w = w + eye
        return w, b

    def forward(self, x):
        w, b = self.rep_params()
        y = F.conv2d(x, w, b, padding=1)
        return y if self.act is None else self.act(y)


class ECBSR(nn.Module):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 32,
                 num_block: int = 4, upscale: int = 4, with_idt: bool = False):
        super().__init__()
        self.upscale = upscale
        blocks = [ECB(num_in_ch, num_feat, with_idt=with_idt)]
        blocks += [ECB(num_feat, num_feat, with_idt=with_idt) for _ in range(num_block)]
        blocks.append(ECB(num_feat, num_out_ch * upscale ** 2, act_type="linear",
                          with_idt=with_idt))
        self.backbone = nn.Sequential(*blocks)

    def forward(self, x):
        out = pixel_shuffle(nhwc(self.backbone(nchw(x))), self.upscale)
        return out + x.repeat_interleave(self.upscale, 1).repeat_interleave(self.upscale, 2)


class _MergeRun(nn.Module):
    def __init__(self, nf: int):
        super().__init__()
        self.dilation1 = nn.Sequential(conv(nf, nf), nn.ReLU(), conv(nf, nf, dilation=2),
                                       nn.ReLU())
        self.dilation2 = nn.Sequential(conv(nf, nf, dilation=3), nn.ReLU(),
                                       conv(nf, nf, dilation=4), nn.ReLU())
        self.aggregation = nn.Sequential(conv(2 * nf, nf), nn.ReLU())

    def forward(self, x):
        return self.aggregation(torch.cat([self.dilation1(x), self.dilation2(x)], 1)) + x


class _EResidualBlock(nn.Module):
    def __init__(self, nf: int):
        super().__init__()
        self.body = nn.Sequential(conv(nf, nf), nn.ReLU(), conv(nf, nf), nn.ReLU(),
                                  conv(nf, nf, 1))

    def forward(self, x):
        return F.relu(self.body(x) + x)


class EAM(nn.Module):
    """Enhancement attention module: merge-and-run, a residual block (then
    ReLU), the enhanced residual block, channel attention."""

    def __init__(self, nf: int, squeeze_factor: int = 16):
        super().__init__()
        self.merge = _MergeRun(nf)
        self.block1 = ResidualBlockNoBN(nf)
        self.block2 = _EResidualBlock(nf)
        self.ca = ChannelAttention(nf, squeeze_factor)

    def forward(self, x):
        return self.ca(self.block2(F.relu(self.block1(self.merge(x)))))


class _MeanShift(nn.Module):
    def __init__(self, img_range: float, mean, std, sign: int):
        super().__init__()
        std_t = torch.tensor(std, dtype=torch.float32)
        self.register_buffer("weight", torch.eye(3).view(3, 3, 1, 1) / std_t.view(3, 1, 1, 1))
        self.register_buffer("bias", sign * img_range * torch.tensor(mean) / std_t)


class RIDNet(nn.Module):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_block: int = 4, img_range: float = 255.0,
                 rgb_mean: Sequence[float] = _RGB_MEAN, rgb_std: Sequence[float] = (1.0, 1.0, 1.0)):
        super().__init__()
        self.img_range, self.rgb_mean, self.rgb_std = img_range, tuple(rgb_mean), tuple(rgb_std)
        self.sub_mean = _MeanShift(img_range, rgb_mean, rgb_std, -1)
        self.add_mean = _MeanShift(img_range, rgb_mean, rgb_std, 1)
        self.head = conv(num_in_ch, num_feat)
        self.body = nn.Sequential(*[EAM(num_feat) for _ in range(num_block)])
        self.tail = conv(num_feat, num_out_ch)

    def forward(self, x):
        mean = torch.tensor(self.rgb_mean, dtype=x.dtype, device=x.device)
        std = torch.tensor(self.rgb_std, dtype=x.dtype, device=x.device)
        res = nchw((x - self.img_range * mean) / std)
        res = nhwc(self.tail(self.body(F.relu(self.head(res)))))
        return x + (res / std + self.img_range * mean / std)


class DEResNet(nn.Module):
    """Degradation estimator: one ResNet branch a degradation, each ending
    in a global mean and a 512-wide MLP; returns a list of [B] degrees."""

    def __init__(self, num_in_ch: int = 3, num_degradation: int = 2,
                 degree_actv: str = "sigmoid", num_feats: Sequence[int] = (64, 128, 256, 512),
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 downscales: Sequence[int] = (2, 2, 2, 1)):
        super().__init__()
        self.degree_actv = degree_actv
        n = len(num_feats)
        self.conv_first = nn.ModuleList()
        self.body = nn.ModuleList()
        self.fc_degree = nn.ModuleList()
        for _ in range(num_degradation):
            self.conv_first.append(conv(num_in_ch, num_feats[0]))
            seq: List[nn.Module] = []
            width = num_feats[0]
            for stage in range(n):
                seq += [ResidualBlockNoBN(num_feats[stage]) for _ in range(num_blocks[stage])]
                if downscales[stage] == 2:
                    nxt = num_feats[min(stage + 1, n - 1)]
                    seq.append(conv(num_feats[stage], nxt, stride=2))
                    width = nxt
                elif stage < n - 1 and num_feats[stage] != num_feats[stage + 1]:
                    seq.append(conv(num_feats[stage], num_feats[stage + 1]))
                    width = num_feats[stage + 1]
                else:
                    width = num_feats[stage]
            self.body.append(nn.Sequential(*seq))
            self.fc_degree.append(nn.Sequential(nn.Linear(width, 512), nn.ReLU(),
                                                nn.Linear(512, 1)))

    def forward(self, x):
        degrees = []
        for first, body, fc in zip(self.conv_first, self.body, self.fc_degree):
            y = fc(body(first(nchw(x))).mean(dim=(2, 3)))
            y = torch.tanh(y) if self.degree_actv == "tanh" else torch.sigmoid(y)
            degrees.append(y[:, 0])
        return degrees

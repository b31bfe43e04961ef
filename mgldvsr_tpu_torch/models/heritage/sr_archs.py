"""Single-image SR backbones: RRDBNet, MSRResNet, SRVGGNetCompact, channel
attention / RCAB, and Real-ESRGAN's U-Net discriminator.

Counterpart of ``mgldvsr_tpu/models/heritage/sr_archs.py``. Images are NHWC
at the module boundary, as in JAX; the convs run NCHW inside. Keys are
basicsr's (``conv_first``, ``body.{i}.rdb{j}.conv{k}``, ``body.{2i}`` /
``body.{2i+1}`` of SRVGG's sequential body, ``rcab.{0,2}`` and
``rcab.3.attention.{1,3}``), the layout the JAX package's converters read.
The U-Net discriminator has no converter: its spectral convs keep torch's
``weight_orig`` / ``weight_u`` / ``weight_v`` names, and run the JAX
package's arithmetic (one power-iteration step from the stored ``u`` on
every call; ``u`` is stored back only under ``update_sv``).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.models.vae import ResidualDenseBlock
from mgldvsr_tpu_torch.ops.resize import image_resize, resize2d


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def resize_nchw(x: torch.Tensor, size, method: str = "bilinear") -> torch.Tensor:
    """The port's ``resize2d`` (the JAX package's) on an NCHW tensor."""
    return nchw(resize2d(nhwc(x), size, method=method))


def conv(cin: int, cout: int, k: int = 3, stride: int = 1, dilation: int = 1,
         bias: bool = True) -> nn.Conv2d:
    """A conv padded as the JAX package's ``_conv`` helpers: (k // 2) * dilation."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k // 2) * dilation,
                     dilation=dilation, bias=bias)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC [N,H,W,C*r^2] -> [N,H*r,W*r,C] in torch's channel order."""
    return nhwc(F.pixel_shuffle(nchw(x), r))


def lrelu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, slope)


class RRDB(nn.Module):
    def __init__(self, num_feat: int, num_grow_ch: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """ESRGAN's generator; ``scale`` 4, 2 or 1 (the smaller two gather
    pixels into channels first, in the JAX package's order)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, scale: int = 4,
                 num_feat: int = 64, num_block: int = 23, num_grow_ch: int = 32):
        super().__init__()
        self.scale = scale
        cin = num_in_ch * {4: 1, 2: 4, 1: 16}[scale]
        self.conv_first = conv(cin, num_feat)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow_ch) for _ in range(num_block)])
        self.conv_body = conv(num_feat, num_feat)
        self.conv_up1 = conv(num_feat, num_feat)
        self.conv_up2 = conv(num_feat, num_feat)
        self.conv_hr = conv(num_feat, num_feat)
        self.conv_last = conv(num_feat, num_out_ch)

    def forward(self, x):
        x = nchw(x)
        if self.scale in (1, 2):
            s = 4 // self.scale
            x = torch.cat([x[:, :, i::s, j::s] for i in range(s) for j in range(s)], dim=1)
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        up = lambda z: z.repeat_interleave(2, 2).repeat_interleave(2, 3)  # noqa: E731
        feat = lrelu(self.conv_up1(up(feat)), 0.2)
        feat = lrelu(self.conv_up2(up(feat)), 0.2)
        return nhwc(self.conv_last(lrelu(self.conv_hr(feat), 0.2)))


class ResidualBlockNoBN(nn.Module):
    """x + conv2(relu(conv1(x))) * res_scale, NCHW."""

    def __init__(self, num_feat: int = 64, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = conv(num_feat, num_feat)
        self.conv2 = conv(num_feat, num_feat)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x))) * self.res_scale


class MSRResNet(nn.Module):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_block: int = 16, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.conv_first = conv(num_in_ch, num_feat)
        self.body = nn.Sequential(*[ResidualBlockNoBN(num_feat) for _ in range(num_block)])
        if upscale in (2, 3):
            self.upconv1 = conv(num_feat, num_feat * upscale * upscale)
        else:
            self.upconv1 = conv(num_feat, num_feat * 4)
            self.upconv2 = conv(num_feat, num_feat * 4)
        self.conv_hr = conv(num_feat, num_feat)
        self.conv_last = conv(num_feat, num_out_ch)

    def forward(self, x):
        n, h, w, _ = x.shape
        body = self.body(lrelu(self.conv_first(nchw(x))))
        if self.upscale in (2, 3):
            body = lrelu(F.pixel_shuffle(self.upconv1(body), self.upscale))
        else:
            body = lrelu(F.pixel_shuffle(self.upconv1(body), 2))
            body = lrelu(F.pixel_shuffle(self.upconv2(body), 2))
        out = nhwc(self.conv_last(lrelu(self.conv_hr(body))))
        return out + resize2d(x, (h * self.upscale, w * self.upscale), "bilinear")


class PReLU(nn.Module):
    """where(x >= 0, x, weight * x) with a weight a channel (NCHW)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.view(1, -1, 1, 1) * x)


class SRVGGNetCompact(nn.Module):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_conv: int = 16, upscale: int = 4, act_type: str = "prelu"):
        super().__init__()
        self.upscale = upscale

        def act():
            return PReLU(num_feat) if act_type == "prelu" else nn.LeakyReLU(0.1)

        layers = [conv(num_in_ch, num_feat), act()]
        for _ in range(num_conv):
            layers += [conv(num_feat, num_feat), act()]
        layers.append(conv(num_feat, num_out_ch * upscale * upscale))
        self.body = nn.Sequential(*layers)

    def forward(self, x):
        out = F.pixel_shuffle(self.body(nchw(x)), self.upscale)
        base = x.repeat_interleave(self.upscale, 1).repeat_interleave(self.upscale, 2)
        return nhwc(out) + base


class ChannelAttention(nn.Module):
    """x * sigmoid(up(relu(down(mean_hw(x))))), NCHW."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(num_feat, num_feat // squeeze_factor, 1),
            nn.ReLU(), nn.Conv2d(num_feat // squeeze_factor, num_feat, 1), nn.Sigmoid())

    def forward(self, x):
        return x * self.attention(x)


class RCAB(nn.Module):
    """Residual channel-attention block, NCHW."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.rcab = nn.Sequential(conv(num_feat, num_feat), nn.ReLU(), conv(num_feat, num_feat),
                                  ChannelAttention(num_feat, squeeze_factor))

    def forward(self, x):
        return x + self.rcab(x) * self.res_scale


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


class SpectralConv(nn.Module):
    """A conv whose weight is divided by its largest singular value, from one
    power-iteration step off the stored ``weight_u`` (the JAX arithmetic).
    ``weight_v`` is kept for the reference's checkpoints and not read."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.stride, self.pad = stride, (k - 1) // 2
        self.weight_orig = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("weight_u", torch.ones(cout) / cout ** 0.5)
        self.register_buffer("weight_v", torch.zeros(cin * k * k))

    def forward(self, x, update_sv: bool = False):
        w = self.weight_orig
        wm = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])  # [(kh, kw, I), O]
        v = _l2_normalize(wm @ self.weight_u)
        u_new = _l2_normalize(wm.t() @ v)
        sigma = (v @ wm) @ u_new
        if update_sv:
            with torch.no_grad():
                self.weight_u.copy_(u_new)
        return F.conv2d(x, w / sigma, self.bias, stride=self.stride, padding=self.pad)


class UNetDiscriminatorSN(nn.Module):
    """Real-ESRGAN's U-Net discriminator: NHWC image -> NHWC logits."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64):
        super().__init__()
        nf = num_feat
        self.conv0 = nn.Conv2d(num_in_ch, nf, 3, padding=1)
        self.conv1 = SpectralConv(nf, nf * 2, 4, 2)
        self.conv2 = SpectralConv(nf * 2, nf * 4, 4, 2)
        self.conv3 = SpectralConv(nf * 4, nf * 8, 4, 2)
        self.conv4 = SpectralConv(nf * 8, nf * 4)
        self.conv5 = SpectralConv(nf * 4, nf * 2)
        self.conv6 = SpectralConv(nf * 2, nf)
        self.conv7 = SpectralConv(nf, nf)
        self.conv8 = SpectralConv(nf, nf)
        self.conv9 = nn.Conv2d(nf, 1, 3, padding=1)

    def forward(self, x, update_sv: bool = False):
        def up(z):
            return nchw(image_resize(nhwc(z), (z.shape[2] * 2, z.shape[3] * 2), "bilinear"))

        u = update_sv
        x0 = lrelu(self.conv0(nchw(x)), 0.2)
        x1 = lrelu(self.conv1(x0, u), 0.2)
        x2 = lrelu(self.conv2(x1, u), 0.2)
        x3 = lrelu(self.conv3(x2, u), 0.2)
        y = lrelu(self.conv4(up(x3), u), 0.2) + x2
        y = lrelu(self.conv5(up(y), u), 0.2) + x1
        y = lrelu(self.conv6(up(y), u), 0.2) + x0
        y = lrelu(self.conv7(y, u), 0.2)
        y = lrelu(self.conv8(y, u), 0.2)
        return nhwc(self.conv9(y))

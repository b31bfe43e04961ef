"""StyleGAN2's generator and discriminator.

Counterpart of ``mgldvsr_tpu/models/heritage/stylegan2.py`` (basicsr's
``stylegan2_arch``): equalised-learning-rate linears and convs, modulated
and demodulated convs (the upsampling one a grouped transposed conv of
stride 2 then a FIR smooth; the downsampling one a FIR smooth then a
stride-2 conv), noise injection, the ToRGB skip pyramid, and the residual
discriminator with the grouped minibatch standard deviation. The resampling
is :mod:`mgldvsr_tpu_torch.ops.stylegan_ops`.

Images are NHWC at the boundary as in JAX; convs run NCHW inside. Noise is
injected (``noises=``, NHWC maps [N or 1, res, res, 1], e.g.
:meth:`StyleGAN2Generator.stored_noises`) or drawn from an explicit
``torch.Generator``; with neither, no noise is added. Keys are basicsr's
(``style_mlp.{i+1}``, ``constant_input.weight``, ``style_conv1.weight`` (the
noise strength), ``style_conv1.activate.bias``, ``to_rgbs.{i}.bias``,
``noises.noise{i}``; the discriminator's ``conv_body.{i}.conv2.{1,2}``,
``final_linear.{0,1}``), the layout the JAX package's converters read.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.models.heritage.sr_archs import nchw, nhwc
from mgldvsr_tpu_torch.ops.stylegan_ops import (
    fused_leaky_relu,
    make_resample_kernel,
    upfirdn2d_nchw,
)

_FIR_TAPS = (1, 3, 3, 1)


def generator_channels(channel_multiplier: int = 2, narrow: float = 1.0) -> Dict[str, int]:
    return {
        "4": int(512 * narrow), "8": int(512 * narrow), "16": int(512 * narrow),
        "32": int(512 * narrow), "64": int(256 * channel_multiplier * narrow),
        "128": int(128 * channel_multiplier * narrow), "256": int(64 * channel_multiplier * narrow),
        "512": int(32 * channel_multiplier * narrow), "1024": int(16 * channel_multiplier * narrow),
    }


def _fir(x: torch.Tensor, upsample_factor: int = 1) -> torch.Tensor:
    k = make_resample_kernel(_FIR_TAPS)
    if upsample_factor > 1:
        k = k * upsample_factor ** 2
    return torch.from_numpy(np.ascontiguousarray(k)).to(x.device)


def upfirdn_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    k = _fir(x, factor)
    pad = k.shape[0] - factor
    return upfirdn2d_nchw(x, k, up=factor, pad=((pad + 1) // 2 + factor - 1, pad // 2))


def upfirdn_smooth(x: torch.Tensor, upsample_factor: int = 1, downsample_factor: int = 1,
                   kernel_size: int = 1) -> torch.Tensor:
    """The FIR-only pass whose padding absorbs the neighbouring strided
    (transposed) conv's geometry (NCHW)."""
    k = _fir(x, upsample_factor)
    if upsample_factor > 1:
        pad = (k.shape[0] - upsample_factor) - (kernel_size - 1)
        p = ((pad + 1) // 2 + upsample_factor - 1, pad // 2 + 1)
    elif downsample_factor > 1:
        pad = (k.shape[0] - downsample_factor) + (kernel_size - 1)
        p = ((pad + 1) // 2, pad // 2)
    else:
        raise NotImplementedError
    return upfirdn2d_nchw(x, k, pad=p)


class EqualLinear(nn.Module):
    def __init__(self, cin: int, cout: int, lr_mul: float = 1.0, bias_init: float = 0.0,
                 activate: bool = False):
        super().__init__()
        self.lr_mul, self.activate = lr_mul, activate
        self.scale = (1 / math.sqrt(cin)) * lr_mul
        self.weight = nn.Parameter(torch.randn(cout, cin) / lr_mul)
        self.bias = nn.Parameter(torch.full((cout,), float(bias_init)))

    def forward(self, x):
        out = x @ (self.weight * self.scale).t()
        if self.activate:
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class EqualConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, padding: int = 0,
                 bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.scale = 1 / math.sqrt(cin * kernel * kernel)
        self.weight = nn.Parameter(torch.randn(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, self.bias, self.stride, self.padding)


class _Smooth(nn.Module):
    def __init__(self, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size

    def forward(self, x):
        return upfirdn_smooth(x, 1, 2, self.kernel_size)


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels: int, bias: bool = True):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.view(1, -1, 1, 1)
        return fused_leaky_relu(x, b)


def ConvLayer(cin: int, cout: int, kernel: int = 3, downsample: bool = False,  # noqa: N802
              bias: bool = True, activate: bool = True) -> nn.Sequential:
    """[a FIR smooth before a stride-2 conv] + EqualConv2d + activation; with
    the activation the bias lives in the FusedLeakyReLU (NCHW)."""
    layers: List[nn.Module] = []
    if downsample:
        layers.append(_Smooth(kernel))
        stride, padding = 2, 0
    else:
        stride, padding = 1, kernel // 2
    layers.append(EqualConv2d(cin, cout, kernel, stride, padding, bias=bias and not activate))
    if activate:
        layers.append(FusedLeakyReLU(cout, bias=bias))
    return nn.Sequential(*layers)


class ModulatedConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, num_style_feat: int,
                 demodulate: bool = True, sample_mode: Optional[str] = None, eps: float = 1e-8):
        super().__init__()
        self.cout, self.kernel, self.demodulate = cout, kernel, demodulate
        self.sample_mode, self.eps = sample_mode, eps
        self.scale = 1 / math.sqrt(cin * kernel * kernel)
        self.modulation = EqualLinear(num_style_feat, cin, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(1, cout, cin, kernel, kernel))

    def forward(self, x, style):
        n, cin, h, w = x.shape
        k = self.kernel
        s = self.modulation(style)
        wmod = self.weight * self.scale * s.view(n, 1, cin, 1, 1)  # [N, O, I, k, k]
        if self.demodulate:
            wmod = wmod * torch.rsqrt(wmod.pow(2).sum(dim=(2, 3, 4), keepdim=True) + self.eps)
        # one grouped conv over the batch: sample i convolves with its own weight
        if self.sample_mode == "upsample":
            wt = wmod.transpose(1, 2).reshape(n * cin, self.cout, k, k)
            out = F.conv_transpose2d(x.reshape(1, n * cin, h, w), wt, stride=2, groups=n)
            return upfirdn_smooth(out.reshape(n, self.cout, out.shape[2], out.shape[3]), 2, 1, k)
        wg = wmod.reshape(n * self.cout, cin, k, k)
        if self.sample_mode == "downsample":
            x = upfirdn_smooth(x, 1, 2, k)
            stride, pad = 2, 0
        else:
            stride, pad = 1, k // 2
        out = F.conv2d(x.reshape(1, n * cin, x.shape[2], x.shape[3]), wg, stride=stride,
                       padding=pad, groups=n)
        return out.reshape(n, self.cout, out.shape[2], out.shape[3])


class StyleConv(nn.Module):
    """ModulatedConv2d + noise injection (``weight`` is its strength) +
    FusedLeakyReLU."""

    def __init__(self, cin: int, cout: int, kernel: int, num_style_feat: int,
                 sample_mode: Optional[str] = None):
        super().__init__()
        self.modulated_conv = ModulatedConv2d(cin, cout, kernel, num_style_feat,
                                              sample_mode=sample_mode)
        self.weight = nn.Parameter(torch.zeros(1))
        self.activate = FusedLeakyReLU(cout)

    def forward(self, x, style, noise=None):
        y = self.modulated_conv(x, style)
        if noise is not None:
            y = y + self.weight * noise
        return self.activate(y)


class ToRGB(nn.Module):
    def __init__(self, cin: int, num_style_feat: int, upsample: bool = True):
        super().__init__()
        self.upsample = upsample
        self.modulated_conv = ModulatedConv2d(cin, 3, 1, num_style_feat, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        y = self.modulated_conv(x, style) + self.bias
        if skip is not None:
            if self.upsample:
                skip = upfirdn_upsample(skip, 2)
            y = y + skip
        return y


class _NormStyleCode(nn.Module):
    def forward(self, z):
        return z * torch.rsqrt(torch.mean(z ** 2, dim=-1, keepdim=True) + 1e-8)


class _Noises(nn.Module):
    pass


class StyleGAN2Generator(nn.Module):
    """``forward(styles [N, num_style_feat], noises=None, generator=None)``
    -> images [N, out, out, 3] (NHWC)."""

    def __init__(self, out_size: int = 64, num_style_feat: int = 512, num_mlp: int = 8,
                 channel_multiplier: int = 2, narrow: float = 1.0):
        super().__init__()
        ch = generator_channels(channel_multiplier, narrow)
        self.log_size = int(math.log2(out_size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.num_latent = self.log_size * 2 - 2
        self.style_mlp = nn.Sequential(_NormStyleCode(), *[
            EqualLinear(num_style_feat, num_style_feat, lr_mul=0.01, activate=True)
            for _ in range(num_mlp)])
        self.constant_input = nn.Module()
        self.constant_input.weight = nn.Parameter(torch.randn(1, ch["4"], 4, 4))
        self.style_conv1 = StyleConv(ch["4"], ch["4"], 3, num_style_feat)
        self.to_rgb1 = ToRGB(ch["4"], num_style_feat, upsample=False)
        self.style_convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        self.noises = _Noises()
        cin = ch["4"]
        for i in range(self.num_layers):
            res = 2 ** ((i + 5) // 2)
            self.noises.register_buffer(f"noise{i}", torch.zeros(1, 1, res, res))
        for res_log in range(3, self.log_size + 1):
            cout = ch[str(2 ** res_log)]
            self.style_convs.append(StyleConv(cin, cout, 3, num_style_feat, "upsample"))
            self.style_convs.append(StyleConv(cout, cout, 3, num_style_feat))
            self.to_rgbs.append(ToRGB(cout, num_style_feat))
            cin = cout

    def stored_noises(self) -> List[torch.Tensor]:
        """The checkpoint's noise maps, NHWC, to pass as ``noises=``."""
        return [nhwc(getattr(self.noises, f"noise{i}")) for i in range(self.num_layers)]

    def forward(self, styles, input_is_latent: bool = False,
                noises: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None, truncation: float = 1.0,
                truncation_latent: Optional[torch.Tensor] = None):
        if not isinstance(styles, (list, tuple)):
            styles = [styles]
        if not input_is_latent:
            styles = [self.style_mlp(z) for z in styles]
        if truncation < 1 and truncation_latent is not None:
            styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]
        latent = styles[0][:, None].expand(-1, self.num_latent, -1)
        n = latent.shape[0]

        def noise(idx: int, shape) -> Optional[torch.Tensor]:
            if noises is not None:
                return None if noises[idx] is None else nchw(noises[idx])
            if generator is not None:
                return torch.randn((shape[0], 1, shape[2], shape[3]), generator=generator,
                                   device=generator.device, dtype=latent.dtype)
            return None

        x = self.constant_input.weight.expand(n, -1, -1, -1)
        x = self.style_conv1(x, latent[:, 0], noise(0, (n, 0, 4, 4)))
        skip = self.to_rgb1(x, latent[:, 1])
        i = 1
        for j, to_rgb in enumerate(self.to_rgbs):
            res = 2 ** (j + 3)
            x = self.style_convs[2 * j](x, latent[:, i], noise(2 * j + 1, (n, 0, res, res)))
            x = self.style_convs[2 * j + 1](x, latent[:, i + 1],
                                            noise(2 * j + 2, (n, 0, res, res)))
            skip = to_rgb(x, latent[:, i + 2], skip)
            i += 2
        return nhwc(skip)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = ConvLayer(cin, cin, 3)
        self.conv2 = ConvLayer(cin, cout, 3, downsample=True)
        self.skip = ConvLayer(cin, cout, 1, downsample=True, bias=False, activate=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


class StyleGAN2Discriminator(nn.Module):
    """``forward(images [N, s, s, 3])`` -> logits [N, 1]."""

    def __init__(self, in_size: int = 64, channel_multiplier: int = 2, narrow: float = 1.0,
                 stddev_group: int = 4, stddev_feat: int = 1):
        super().__init__()
        ch = generator_channels(channel_multiplier, narrow)
        log_size = int(math.log2(in_size))
        self.stddev_group, self.stddev_feat = stddev_group, stddev_feat
        body: List[nn.Module] = [ConvLayer(3, ch[str(in_size)], 1)]
        cin = ch[str(in_size)]
        for i in range(log_size, 2, -1):
            cout = ch[str(2 ** (i - 1))]
            body.append(ResBlock(cin, cout))
            cin = cout
        self.conv_body = nn.Sequential(*body)
        self.final_conv = ConvLayer(cin + 1, ch["4"], 3)
        self.final_linear = nn.Sequential(EqualLinear(ch["4"] * 16, ch["4"], activate=True),
                                          EqualLinear(ch["4"], 1))

    def forward(self, x):
        h = self.conv_body(nchw(x))
        b, c, hh, ww = h.shape
        group = min(b, self.stddev_group)
        sd = h.reshape(group, -1, self.stddev_feat, c // self.stddev_feat, hh, ww)
        sd = torch.sqrt(sd.var(dim=0, unbiased=False) + 1e-8)
        sd = sd.mean(dim=(2, 3, 4), keepdim=True).squeeze(2)
        h = torch.cat([h, sd.repeat(group, 1, hh, ww)], dim=1)
        return self.final_linear(self.final_conv(h).reshape(b, -1))

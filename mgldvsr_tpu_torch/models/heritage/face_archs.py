"""Face restoration: DFDNet and HiFaceGAN (generator and multiscale
discriminator), with the VGG19 feature extractor DFDNet reads.

Counterpart of ``mgldvsr_tpu/models/heritage/face_archs.py``. Spectral norm
is folded into the weights when a checkpoint is converted (eval-mode
``W / sigma`` from the stored vectors), so every conv here is plain. DFDNet's
dictionary swap works on face boxes that depend on the data: it runs as host
code over fixed-shape pieces at batch 1, as the reference and the JAX package
do; the dictionaries are the caller's ({feature size: {part: [N, h, w, C]}},
NHWC). Images are NHWC at the boundary; convs run NCHW inside. Keys are
basicsr's (``vgg_extractor.vgg_net.conv1_1``, ``attn_blocks.nose_64.{0,2}``,
``upsample0.scale_block.2``, ``lip_encoder.model.{k}.logit.{0,1}``,
``ups.{i}.norm_s.mlp_shared.0``, ``discriminator_{i}.model{n}.0.0``), the
layout the JAX package's converters read.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.models.heritage.sr_archs import conv, nchw, nhwc
from mgldvsr_tpu_torch.ops.resize import image_resize


def lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per sample and channel over H, W (NCHW), biased variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def adaptive_instance_norm(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """AdaIN with the unbiased std, on NHWC tensors."""

    def stats(f):
        n = f.shape[1] * f.shape[2]
        mean = f.mean(dim=(1, 2), keepdim=True)
        var = f.var(dim=(1, 2), unbiased=False, keepdim=True) * (n / max(n - 1, 1))
        return mean, torch.sqrt(var + 1e-5)

    c_mean, c_std = stats(content)
    s_mean, s_std = stats(style)
    return (content - c_mean) / c_std * s_std + s_mean


def nearest_resize_torch(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC nearest resize with torch's legacy rule src = floor(dst * in / out)."""
    ih, iw = x.shape[1:3]
    ri = torch.floor(torch.arange(h, dtype=torch.float32) * (ih / h)).long().to(x.device)
    ci = torch.floor(torch.arange(w, dtype=torch.float32) * (iw / w)).long().to(x.device)
    return x[:, ri][:, :, ci]


_VGG19_PLAN = (
    ("conv1_1", 64), ("conv1_2", 64), ("conv2_1", 128), ("conv2_2", 128),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512),
)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG19Features(nn.Module):
    """VGG19 with named taps (``convN_M`` or ``reluN_M``), max-pool between
    blocks; ``range_norm`` maps [-1, 1] to [0, 1] first, then ImageNet
    normalisation. ``forward`` returns NHWC taps."""

    def __init__(self, taps: Sequence[str] = ("relu2_2", "relu3_4", "relu4_4", "conv5_4"),
                 use_input_norm: bool = True, range_norm: bool = True):
        super().__init__()
        self.taps, self.use_input_norm, self.range_norm = tuple(taps), use_input_norm, range_norm
        self.needed = max(i for i, (name, _) in enumerate(_VGG19_PLAN)
                          if name in self.taps or f"relu{name[4:]}" in self.taps)
        convs, cin = {}, 3
        for name, ch in _VGG19_PLAN[:self.needed + 1]:
            convs[name] = nn.Conv2d(cin, ch, 3, padding=1)
            cin = ch
        self.vgg_net = nn.ModuleDict(convs)

    def features_nchw(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = ((x - torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device))
                 / torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device))
        x = nchw(x)
        out, prev = {}, "1"
        for name, _ in _VGG19_PLAN[:self.needed + 1]:
            if name[4] != prev:
                x = F.max_pool2d(x, 2, 2)
                prev = name[4]
            x = self.vgg_net[name](x)
            if name in self.taps:
                out[name] = x
            x = F.relu(x)
            if f"relu{name[4:]}" in self.taps:
                out[f"relu{name[4:]}"] = x
        return out

    def forward(self, x):
        return {k: nhwc(v) for k, v in self.features_nchw(x).items()}


class Blur(nn.Module):
    """The fixed binomial 3x3 blur, a channel at a time (NCHW)."""

    def forward(self, x):
        k = torch.tensor([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=x.dtype, device=x.device) / 16.0
        c = x.shape[1]
        return F.conv2d(x, k.expand(c, 1, 3, 3), padding=1, groups=c)


def _attention_block(ch: int) -> nn.Sequential:
    return nn.Sequential(conv(ch, ch), nn.LeakyReLU(0.2), conv(ch, ch))


class MSDilationBlock(nn.Module):
    def __init__(self, cin: int, ch: int, dilations: Sequence[int] = (4, 3, 2, 1)):
        super().__init__()
        self.conv_blocks = nn.ModuleList([
            nn.Sequential(conv(cin, ch, dilation=d), nn.LeakyReLU(0.2), conv(ch, ch, dilation=d))
            for d in dilations])
        self.conv_fusion = conv(ch * len(dilations), ch)

    def forward(self, x):
        return self.conv_fusion(torch.cat([b(x) for b in self.conv_blocks], 1)) + x


class SFTUpBlock(nn.Module):
    """Blur + conv, SFT scale and shift (ending in a sigmoid) from the
    dictionary-updated features, x2 bilinear, conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Sequential(Blur(), conv(cin, cout))
        self.convup = nn.Sequential(nn.Identity(), conv(cout, cout))
        self.scale_block = nn.Sequential(conv(cin, cout), nn.LeakyReLU(0.2),
                                         conv(cout, cout, bias=False))
        self.shift_block = nn.Sequential(conv(cin, cout), nn.LeakyReLU(0.2),
                                         conv(cout, cout, bias=False))

    def forward(self, x, updated):
        h = lrelu(self.conv1(x), 0.04)
        h = h * self.scale_block(updated) + torch.sigmoid(self.shift_block(updated))
        h = nchw(image_resize(nhwc(h), (h.shape[2] * 2, h.shape[3] * 2), "bilinear"))
        return lrelu(self.convup(h))


class _UpResBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.body = nn.Sequential(conv(ch, ch), nn.LeakyReLU(0.2), conv(ch, ch))

    def forward(self, x):
        return x + self.body(x)


PARTS = ("left_eye", "right_eye", "nose", "mouth")
FEATURE_SIZES = (256, 128, 64, 32)
CHANNEL_SIZES = (128, 256, 512, 512)
VGG_TAPS = ("relu2_2", "relu3_4", "relu4_4", "conv5_4")


class DFDNet(nn.Module):
    """``forward(x [1,H,W,3] in [-1, 1], part_locations)`` -> [1,H,W,3];
    ``part_locations``: four boxes (x0, y0, x1, y1) on the 512 scale, left
    eye, right eye, nose, mouth."""

    def __init__(self, num_feat: int = 64,
                 dictionary: Mapping[Any, Mapping[str, torch.Tensor]] = None):
        super().__init__()
        nf = num_feat
        self.dictionary = {str(k): dict(v) for k, v in (dictionary or {}).items()}
        self.vgg_extractor = VGG19Features(taps=VGG_TAPS)
        self.attn_blocks = nn.ModuleDict({f"{part}_{fs}": _attention_block(ch)
                                          for fs, ch in zip(FEATURE_SIZES, CHANNEL_SIZES)
                                          for part in PARTS})
        self.multi_scale_dilation = MSDilationBlock(512, nf * 8)
        self.upsample0 = SFTUpBlock(nf * 8, nf * 8)
        self.upsample1 = SFTUpBlock(nf * 8, nf * 4)
        self.upsample2 = SFTUpBlock(nf * 4, nf * 2)
        self.upsample3 = SFTUpBlock(nf * 2, nf)
        self.upsample4 = nn.Sequential(conv(nf, nf), nn.LeakyReLU(0.2), _UpResBlock(nf),
                                       _UpResBlock(nf), conv(nf, 3), nn.Tanh())

    def _swap_part(self, vgg_feat, updated, box, part: str, f_size: int):
        x0, y0, x1, y1 = [int(v) for v in box]
        part_feat = vgg_feat[:, y0:y1, x0:x1, :]
        dict_feat = torch.as_tensor(self.dictionary[str(f_size)][part]).to(vgg_feat)
        n, dh, dw, c = dict_feat.shape
        part_resize = image_resize(part_feat, (dh, dw), "bilinear", antialias=False)
        dict_feat = adaptive_instance_norm(dict_feat, part_resize)
        score = part_resize.reshape(1, -1) @ dict_feat.reshape(n, -1).t()
        idx = int(torch.argmax(torch.softmax(score.reshape(-1), dim=0)))
        swap = nearest_resize_torch(dict_feat[idx:idx + 1], y1 - y0, x1 - x0)
        attn = nhwc(self.attn_blocks[f"{part}_{f_size}"](nchw(swap - part_feat)))
        updated = updated.clone()
        updated[:, y0:y1, x0:x1, :] = attn * swap + part_feat
        return updated

    def forward(self, x, part_locations):
        feats = self.vgg_extractor(x)
        updated_feats: List[torch.Tensor] = []
        for tap, f_size in zip(VGG_TAPS, FEATURE_SIZES):
            updated = feats[tap]
            for part_idx, part in enumerate(PARTS):
                box = [int(v // (512 / f_size)) for v in part_locations[part_idx]]
                if str(f_size) in self.dictionary:
                    updated = self._swap_part(feats[tap], updated, box, part, f_size)
            updated_feats.append(nchw(updated))
        h = self.multi_scale_dilation(nchw(feats["conv5_4"]))
        h = self.upsample0(h, updated_feats[3])
        h = self.upsample1(h, updated_feats[2])
        h = self.upsample2(h, updated_feats[1])
        h = self.upsample3(h, updated_feats[0])
        return nhwc(self.upsample4(h))


class HFGSpade(nn.Module):
    """HiFaceGAN's SPADE: instance norm, the image (nearest-resized) as the
    guidance map, a shared conv, then gamma and beta convs without bias."""

    def __init__(self, norm_nc: int, label_nc: int = 3, ks: int = 3):
        super().__init__()
        nhidden = 128 if norm_nc > 128 else norm_nc
        self.mlp_shared = nn.Sequential(conv(label_nc, nhidden, ks), nn.ReLU())
        self.mlp_gamma = conv(nhidden, norm_nc, ks, bias=False)
        self.mlp_beta = conv(nhidden, norm_nc, ks, bias=False)

    def forward(self, x, segmap):
        seg = nchw(nearest_resize_torch(segmap, x.shape[2], x.shape[3]))
        actv = self.mlp_shared(seg)
        return instance_norm(x) * self.mlp_gamma(actv) + self.mlp_beta(actv)


class SPADEResnetBlock(nn.Module):
    def __init__(self, fin: int, fout: int):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.conv_0 = conv(fin, fmiddle)
        self.conv_1 = conv(fmiddle, fout)
        self.norm_0 = HFGSpade(fin)
        self.norm_1 = HFGSpade(fmiddle)
        if self.learned_shortcut:
            self.conv_s = conv(fin, fout, 1, bias=False)
            self.norm_s = HFGSpade(fin)

    def forward(self, x, seg):
        dx = self.conv_0(lrelu(self.norm_0(x, seg)))
        dx = self.conv_1(lrelu(self.norm_1(dx, seg)))
        if self.learned_shortcut:
            x = self.conv_s(self.norm_s(x, seg))
        return x + dx


def _window_sum(x: torch.Tensor) -> torch.Tensor:
    """3x3 sums at stride 2, zero padding 1 (NCHW)."""
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=True, divisor_override=1)


class _Affine(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))


class SimplifiedLIP(nn.Module):
    """Local-importance pooling: sum(x e^logit) / sum(e^logit) over 3x3
    windows at stride 2, logit = 12 sigmoid(IN_affine(conv(x)))."""

    def __init__(self, ch: int):
        super().__init__()
        self.logit = nn.ModuleList([conv(ch, ch, bias=False), _Affine(ch)])

    def forward(self, x):
        aff = self.logit[1]
        h = instance_norm(self.logit[0](x))
        h = h * aff.weight.view(1, -1, 1, 1) + aff.bias.view(1, -1, 1, 1)
        w = torch.exp(torch.sigmoid(h) * 12.0)
        return _window_sum(x * w) / (_window_sum(w) + 1e-12)


class LIPEncoder(nn.Module):
    """conv-IN-ReLU stem, then ``n_2xdown`` LIP stages; ``model`` holds the
    reference's sequential indices."""

    def __init__(self, ngf: int, n_2xdown: int = 5, num_in_ch: int = 3):
        super().__init__()
        self.n_2xdown = n_2xdown
        layers = {"0": conv(num_in_ch, ngf, bias=False)}
        seq, cur = 3, 1
        self.stages = []
        for i in range(n_2xdown):
            nxt = min(cur * 2, 16)
            layers[str(seq)] = SimplifiedLIP(ngf * cur)
            layers[str(seq + 1)] = conv(ngf * cur, ngf * nxt)
            self.stages.append((str(seq), str(seq + 1)))
            seq += 4 if i < n_2xdown - 1 else 3
            cur = nxt
        self.model = nn.ModuleDict(layers)

    def forward(self, x):
        h = F.relu(instance_norm(self.model["0"](x)))
        for i, (lip, cv) in enumerate(self.stages):
            h = instance_norm(self.model[cv](self.model[lip](h)))
            if i < self.n_2xdown - 1:
                h = F.relu(h)
        return h


class HiFaceGAN(nn.Module):
    """``forward(x [N,H,W,3])`` -> [N,H,W,3] in [-1, 1]: the LIP encoder (or
    a nearest downsample and a conv, ``lip_encoder=False``), SPADE head,
    two middle blocks and ``n_up_stages`` up stages, tanh RGB."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, lip_encoder: bool = True,
                 n_up_stages: int = 4):
        super().__init__()
        nf = num_feat
        self.use_lip, self.n_up_stages = lip_encoder, n_up_stages
        if lip_encoder:
            self.lip_encoder = LIPEncoder(nf, num_in_ch=num_in_ch)
        else:
            self.fc = conv(num_in_ch, 16 * nf)
        self.head_0 = SPADEResnetBlock(16 * nf, 16 * nf)
        self.g_middle_0 = SPADEResnetBlock(16 * nf, 16 * nf)
        self.g_middle_1 = SPADEResnetBlock(16 * nf, 16 * nf)
        mults = (8, 4, 2, 1)
        self.ups = nn.ModuleList([
            SPADEResnetBlock(16 * nf if i == 0 else mults[i - 1] * nf, mults[i] * nf)
            for i in range(n_up_stages)])
        self.to_rgbs = nn.ModuleDict({str(n_up_stages - 1): conv(mults[n_up_stages - 1] * nf, 3)})

    def forward(self, x):
        seg = x
        if self.use_lip:
            h = self.lip_encoder(nchw(x))
        else:
            h = self.fc(nchw(nearest_resize_torch(x, x.shape[1] // 32, x.shape[2] // 32)))

        def up(z):
            return z.repeat_interleave(2, 2).repeat_interleave(2, 3)

        h = up(self.head_0(h, seg))
        h = self.g_middle_1(self.g_middle_0(h, seg), seg)
        for block in self.ups:
            h = block(up(h), seg)
        return nhwc(torch.tanh(self.to_rgbs[str(self.n_up_stages - 1)](lrelu(h))))


class NLayerDiscriminator(nn.Module):
    """A PatchGAN stage: k4 convs (the last body conv at stride 1), folded
    spectral norm and instance norm; returns every layer's NHWC output."""

    def __init__(self, num_in_ch: int, num_feat: int = 64, n_layers: int = 4):
        super().__init__()
        self.n_layers = n_layers
        nf = num_feat
        self.model0 = nn.Sequential(nn.Conv2d(num_in_ch, nf, 4, 2, 2))
        for n in range(1, n_layers):
            nxt = min(nf * 2, 512)
            stride = 1 if n == n_layers - 1 else 2
            setattr(self, f"model{n}", nn.Sequential(nn.Sequential(
                nn.Conv2d(nf, nxt, 4, stride, 2, bias=False))))
            nf = nxt
        setattr(self, f"model{n_layers}", nn.Sequential(nn.Conv2d(nf, 1, 4, 1, 2)))

    def forward(self, x) -> List[torch.Tensor]:
        h = lrelu(self.model0(x))
        results = [h]
        for n in range(1, self.n_layers):
            h = lrelu(instance_norm(getattr(self, f"model{n}")(h)))
            results.append(h)
        results.append(getattr(self, f"model{self.n_layers}")(h))
        return [nhwc(r) for r in results]


class HiFaceGANDiscriminator(nn.Module):
    """``num_d`` PatchGAN stages, each on a x2-downsampled input (3x3 mean
    without the padding, stride 2); input NHWC, e.g. cat(LQ, rendered)."""

    def __init__(self, num_in_ch: int = 6, num_d: int = 2, n_layers: int = 4,
                 num_feat: int = 64):
        super().__init__()
        self.num_d = num_d
        for i in range(num_d):
            setattr(self, f"discriminator_{i}", NLayerDiscriminator(num_in_ch, num_feat, n_layers))

    def forward(self, x) -> List[List[torch.Tensor]]:
        x = nchw(x)
        out = []
        for i in range(self.num_d):
            out.append(getattr(self, f"discriminator_{i}")(x))
            x = _window_sum(x) / _window_sum(torch.ones_like(x[:, :1]))
        return out

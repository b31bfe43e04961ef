"""KL video autoencoder with temporal decoder layers and LQ-feature fusion.

Counterpart of ``mgldvsr_tpu/models/vae.py``, laid out as upstream's
Encoder / VideoDecoder_Mix / VideoAutoencoderKLResi (``down.{i}.block.{j}``,
``mid.block_1``, ``up.{i}.temporal_mixing.{j}``, ``fusion_layer_{i}``, ...)
so the state-dict keys are upstream's. ``ResidualDenseBlock`` is the plain
concat form; the JAX package's decomposed form is a TPU rewrite of it.

``use_checkpoint`` recomputes each decoder res block and fusion block in the
backward (non-reentrant ``torch.utils.checkpoint``) instead of keeping its
activations: the stage-2 memory lever. The JAX package's ``remat_min_res``
(remat only above a resolution) is a TPU fit lever and is not ported: the
config takes its default 0 and refuses any other value.

``dropout`` is accepted and inert, as it is in the JAX package, whose
Encoder and Decoder never pass ``deterministic=False`` to their res blocks.
``AutoencoderKL`` is the frozen image VAE of SD: no temporal layers, no
fusion.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from mgldvsr_tpu_torch.models.layers import (
    GroupNorm,
    Upsample,
    VAEAttnBlock,
    VAEDownsample,
    VAEResnetBlock,
    conv1x1,
    conv3x3,
    norm_silu_conv,
)
from mgldvsr_tpu_torch.models.temporal import SpatialTemporalConv


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    out_ch: int = 3
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Sequence[int] = ()
    resolution: int = 512
    in_channels: int = 3
    z_channels: int = 4
    double_z: bool = True
    embed_dim: int = 4
    dropout: float = 0.0         # inert, as in the JAX package
    num_frames: int = 1          # >1 adds temporal mixing in the decoder
    enable_fusion: bool = False  # LQ-feature fusion taps at up-levels 1, 2
    num_fuse_block: int = 2
    use_checkpoint: bool = False  # recompute decoder blocks in the backward
    remat_min_res: int = 0       # the JAX package's TPU-only remat selectivity: 0 only
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.remat_min_res != 0:
            raise ValueError(
                f"VAEConfig.remat_min_res={self.remat_min_res!r}: selective remat by "
                f"resolution is a TPU-only option of the JAX package and is not ported; "
                f"use use_checkpoint=True (every decoder block recomputed) and leave "
                f"remat_min_res at 0")


class _Level(nn.Module):
    pass


class _Mid(nn.Module):
    def __init__(self, c: int, dtype):
        super().__init__()
        self.block_1 = VAEResnetBlock(c, c, dtype)
        self.attn_1 = VAEAttnBlock(c, dtype)
        self.block_2 = VAEResnetBlock(c, c, dtype)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.conv_in = conv3x3(cfg.in_channels, cfg.ch)
        curr_res = cfg.resolution
        block_in = cfg.ch
        self.down = nn.ModuleList()
        for i, mult in enumerate(cfg.ch_mult):
            level = _Level()
            block_out = cfg.ch * mult
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                level.block.append(VAEResnetBlock(block_in, block_out, dt))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(VAEAttnBlock(block_in, dt))
            if i != len(cfg.ch_mult) - 1:
                level.downsample = VAEDownsample(block_in)
                curr_res //= 2
            self.down.append(level)
        self.mid = _Mid(block_in, dt)
        self.norm_out = GroupNorm(block_in, eps=1e-6, dtype=dt)
        out_c = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = conv3x3(block_in, out_c)

    def forward(self, x, return_fea: bool = False):
        h = self.conv_in(x)
        fea_list: List[torch.Tensor] = []
        for i, level in enumerate(self.down):
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if return_fea and i in (1, 2):
                fea_list.append(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        h = norm_silu_conv(self.norm_out, self.conv_out, h)
        return (h, fea_list) if return_fea else h


class SimpleResBlock(nn.Module):
    """norm-swish-conv twice with a 1x1 skip (key ``conv_out``)."""

    def __init__(self, cin: int, cout: int, dtype):
        super().__init__()
        self.norm1 = GroupNorm(cin, eps=1e-6, dtype=dtype)
        self.conv1 = conv3x3(cin, cout)
        self.norm2 = GroupNorm(cout, eps=1e-6, dtype=dtype)
        self.conv2 = conv3x3(cout, cout)
        if cin != cout:
            self.conv_out = conv1x1(cin, cout)

    def forward(self, x):
        h = norm_silu_conv(self.norm1, self.conv1, x)
        h = norm_silu_conv(self.norm2, self.conv2, h)
        if hasattr(self, "conv_out"):
            x = self.conv_out(x)
        return x + h


class ResidualDenseBlock(nn.Module):
    """RRDB dense block: five densely connected 3x3 convs, LeakyReLU 0.2,
    residual scaled by 0.2."""

    def __init__(self, num_feat: int, num_grow_ch: int = 32):
        super().__init__()
        g = num_grow_ch
        self.conv1 = conv3x3(num_feat, g)
        self.conv2 = conv3x3(num_feat + g, g)
        self.conv3 = conv3x3(num_feat + 2 * g, g)
        self.conv4 = conv3x3(num_feat + 3 * g, g)
        self.conv5 = conv3x3(num_feat + 4 * g, num_feat)

    def forward(self, x):
        x = x.to(self.conv1.weight.dtype)
        x1 = F.leaky_relu(self.conv1(x), 0.2)
        x2 = F.leaky_relu(self.conv2(torch.cat([x, x1], 1)), 0.2)
        x3 = F.leaky_relu(self.conv3(torch.cat([x, x1, x2], 1)), 0.2)
        x4 = F.leaky_relu(self.conv4(torch.cat([x, x1, x2, x3], 1)), 0.2)
        x5 = self.conv5(torch.cat([x, x1, x2, x3, x4], 1))
        return x + 0.2 * x5


class FuseBlock(nn.Module):
    """concat(enc, dec) -> ResBlock -> RDB x n -> ResBlock; dec + w * that."""

    def __init__(self, channels: int, num_block: int, dtype):
        super().__init__()
        self.encode_enc_1 = SimpleResBlock(2 * channels, channels, dtype)
        self.encode_enc_2 = nn.ModuleList([ResidualDenseBlock(channels)
                                           for _ in range(num_block)])
        self.encode_enc_3 = SimpleResBlock(channels, channels, dtype)

    def forward(self, enc_feat, dec_feat, w: float = 1.0):
        h = self.encode_enc_1(torch.cat([enc_feat.to(dec_feat.dtype), dec_feat], 1))
        for rdb in self.encode_enc_2:
            h = rdb(h)
        return dec_feat + w * self.encode_enc_3(h)


class Decoder(nn.Module):
    """SD-VAE decoder; ``num_frames > 1`` adds a temporal conv after every
    res block and after mid block 1, ``enable_fusion`` the fusion taps at
    up-levels 1 and 2 (after that level's blocks, before its upsample)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        temporal = cfg.num_frames > 1
        n_levels = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (n_levels - 1)
        self.conv_in = conv3x3(cfg.z_channels, block_in)
        self.mid = _Mid(block_in, dt)
        if temporal:
            self.temporal_mixing = SpatialTemporalConv(block_in, cfg.num_frames)
        up = [None] * n_levels
        for i in reversed(range(n_levels)):
            level = _Level()
            block_out = cfg.ch * cfg.ch_mult[i]
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            if temporal:
                level.temporal_mixing = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(VAEResnetBlock(block_in, block_out, dt))
                block_in = block_out
                if temporal:
                    level.temporal_mixing.append(SpatialTemporalConv(block_in, cfg.num_frames))
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(VAEAttnBlock(block_in, dt))
            if cfg.enable_fusion and i in (1, 2):
                setattr(self, f"fusion_layer_{i}", FuseBlock(block_in, cfg.num_fuse_block, dt))
            if i != 0:
                level.upsample = Upsample(block_in)
                curr_res *= 2
            up[i] = level
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(block_in, eps=1e-6, dtype=dt)
        self.conv_out = conv3x3(block_in, cfg.out_ch)

    def _run(self, block: nn.Module, *args):
        """``block(*args)``, recomputed in the backward under
        ``use_checkpoint`` when a gradient is being recorded."""
        if self.cfg.use_checkpoint and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, z, enc_fea: Optional[Sequence[torch.Tensor]] = None,
                fusion_w: float = 1.0):
        h = self._run(self.mid.block_1, self.conv_in(z))
        if hasattr(self, "temporal_mixing"):
            h = self.temporal_mixing(h)
        h = self._run(self.mid.block_2, self.mid.attn_1(h))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for j, block in enumerate(level.block):
                h = self._run(block, h)
                if hasattr(level, "temporal_mixing"):
                    h = level.temporal_mixing[j](h)
                if len(level.attn):
                    h = level.attn[j](h)
            if enc_fea is not None and hasattr(self, f"fusion_layer_{i}"):
                h = self._run(getattr(self, f"fusion_layer_{i}"), enc_fea[i - 1], h, fusion_w)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return norm_silu_conv(self.norm_out, self.conv_out, h)


class DiagonalGaussian:
    """Posterior from moments = [mean | logvar] on the channel axis
    (``dim``: -1 for NHWC, 1 for NCHW)."""

    def __init__(self, moments: torch.Tensor, dim: int = -1):
        self.mean, logvar = moments.chunk(2, dim=dim)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator]) -> torch.Tensor:
        eps = torch.randn(self.mean.shape, generator=generator, dtype=self.mean.dtype,
                          device=self.mean.device)
        return self.mean + self.std * eps

    def mode(self) -> torch.Tensor:
        return self.mean


def is_temporal_or_fusion(name: str) -> bool:
    """Whether a parameter of :class:`VideoAutoencoderKLResi` (by its name)
    belongs to the decoder's temporal mixing or fusion layers:
    ``decoder.fusion_layer_{i}.*``, ``decoder.temporal_mixing.*`` and
    ``decoder.up.{i}.temporal_mixing.{j}.*``. The JAX package's flax paths
    for them (``fusion_layer_{i}``, ``mid_temporal``, ``up_{i}_temporal_{j}``)
    are picked by the same two words."""
    return "fusion_layer" in name or "temporal" in name


class VideoAutoencoderKLResi(nn.Module):
    """encode(x) -> (moments, enc_fea); decode(z, enc_fea, w) -> pixels.
    All NCHW."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = conv1x1(2 * cfg.z_channels, 2 * cfg.embed_dim)
        self.post_quant_conv = conv1x1(cfg.embed_dim, cfg.z_channels)

    def encode(self, x):
        h, enc_fea = self.encoder(x, return_fea=True)
        return self.quant_conv(h), enc_fea

    def decode(self, z, enc_fea, fusion_w: float = 1.0):
        return self.decoder(self.post_quant_conv(z), enc_fea, fusion_w)


class AutoencoderKL(nn.Module):
    """The frozen SD image VAE (upstream ``AutoencoderKL``): the encoder, a
    decoder with neither temporal layers nor fusion, and the quant convs.
    All NCHW."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(dataclasses.replace(cfg, num_frames=1, enable_fusion=False))
        self.quant_conv = conv1x1(2 * cfg.z_channels, 2 * cfg.embed_dim)
        self.post_quant_conv = conv1x1(cfg.embed_dim, cfg.z_channels)

    def encode_moments(self, x):
        return self.quant_conv(self.encoder(x))

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x):
        mean, _ = self.encode_moments(x).chunk(2, dim=1)
        return self.decode(mean)

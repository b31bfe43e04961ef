"""The noisy-latent image classifier.

Counterpart of ``mgldvsr_tpu/models/classifier.py`` (the reference's
``NoisyLatentImageClassifier``, rebuilt from its guided-diffusion lineage):
a timestep-aware half UNet over diffusion latents noised to step t, with
an ``attention`` pool (CLIP's ``AttentionPool2d``: the mean token queries
every token), an ``adaptive`` one (the spatial mean and a Linear) or a
``spatial`` one (flattened, an MLP).

The trunk is the UNet's: ``time_embed`` (:func:`~mgldvsr_tpu_torch.models.
layers.timestep_embed_mlp`), ``input_blocks`` of
:class:`~mgldvsr_tpu_torch.models.layers.UNetResBlock` and
:class:`~mgldvsr_tpu_torch.models.attention_blocks.QKVAttentionBlock` with
:class:`~mgldvsr_tpu_torch.models.layers.Downsample` between levels,
``middle_block``; the head is ``out``. Latents are NHWC at the boundary,
NCHW inside. The JAX module reads the latents' side off its first input;
here ``ClassifierConfig.image_size`` gives it to the pool's positions and
the spatial head's width at construction.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn

from mgldvsr_tpu_torch.core.schedules import timestep_embedding
from mgldvsr_tpu_torch.models.attention_blocks import QKVAttentionBlock
from mgldvsr_tpu_torch.models.layers import (Downsample, Linear, UNetResBlock, conv3x3,
                                             timestep_embed_mlp)


class AttentionPool2d(nn.Module):
    """[B,C,H,W] -> [B, out_dim]: tokens = [mean, pixels...] plus a learned
    position each, one multi-head attention with the mean token as the
    query, its output projected."""

    def __init__(self, tokens: int, channels: int, num_heads: int, out_dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.positional_embedding = nn.Parameter(torch.empty(tokens, channels))
        self.q_proj = Linear(channels, channels)
        self.k_proj = Linear(channels, channels)
        self.v_proj = Linear(channels, channels)
        self.c_proj = Linear(channels, out_dim)

    def forward(self, x):
        b, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2).float()
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = (tokens + self.positional_embedding[None].float()).to(self.dtype)
        d = c // self.num_heads
        q = self.q_proj(tokens[:, :1]).reshape(b, 1, self.num_heads, d)
        k = self.k_proj(tokens).reshape(b, -1, self.num_heads, d)
        v = self.v_proj(tokens).reshape(b, -1, self.num_heads, d)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
            torch.tensor(float(d))).to(q.dtype)
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, c)
        return self.c_proj(out)


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    in_channels: int = 4  # SD latents
    model_channels: int = 64
    num_classes: int = 1000
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (4, 8)
    channel_mult: Sequence[int] = (1, 2, 4)
    num_heads: int = 4
    pool: str = "attention"  # adaptive | attention | spatial
    image_size: int = 32  # the latents' side
    dtype: torch.dtype = torch.float32


class NoisyLatentClassifier(nn.Module):
    """logits [B, num_classes] float32 = f(z_t [B,H,W,C], t [B])."""

    def __init__(self, cfg: ClassifierConfig = ClassifierConfig()):
        super().__init__()
        if cfg.pool not in ("attention", "adaptive", "spatial"):
            raise ValueError(f"unknown pool {cfg.pool!r}")
        self.cfg = cfg
        dt, mc = cfg.dtype, cfg.model_channels
        emb_dim = mc * 4
        self.time_embed = timestep_embed_mlp(mc, emb_dim)
        blocks = [nn.ModuleList([conv3x3(cfg.in_channels, mc)])]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [UNetResBlock(ch, mult * mc, emb_dim, dt)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(QKVAttentionBlock(ch, cfg.num_heads, dt))
                blocks.append(nn.ModuleList(layers))
            if level != len(cfg.channel_mult) - 1:
                blocks.append(nn.ModuleList([Downsample(ch)]))
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([UNetResBlock(ch, ch, emb_dim, dt),
                                           QKVAttentionBlock(ch, cfg.num_heads, dt),
                                           UNetResBlock(ch, ch, emb_dim, dt)])
        side = cfg.image_size // ds
        if cfg.pool == "attention":
            self.out = AttentionPool2d(side * side + 1, ch, cfg.num_heads, cfg.num_classes, dt)
        elif cfg.pool == "adaptive":
            self.out = Linear(ch, cfg.num_classes)
        else:
            self.out = nn.Sequential(Linear(side * side * ch, 2 * mc), nn.ReLU(),
                                     Linear(2 * mc, cfg.num_classes))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        emb = self.time_embed(timestep_embedding(timesteps, cfg.model_channels))
        h = x.permute(0, 3, 1, 2).to(cfg.dtype)
        for block in list(self.input_blocks) + [self.middle_block]:
            for layer in block:
                h = layer(h, emb) if isinstance(layer, UNetResBlock) else layer(h)
        if cfg.pool == "attention":
            out = self.out(h)
        elif cfg.pool == "adaptive":
            out = self.out(h.float().mean(dim=(2, 3)).to(h.dtype))
        else:
            out = self.out(h.permute(0, 2, 3, 1).flatten(1))
        return out.float()

"""The dual-conditioned inflated denoiser UNet and the struct-cond encoder.

Counterpart of ``mgldvsr_tpu/models/unet.py``, laid out as upstream's
InflatedUNetModelDualcondV2 and InflatedEncoderUNetModelWT (``input_blocks``
/ ``middle_block`` / ``output_blocks`` / ``out``; ``fea_tran``) so the
state-dict keys are upstream's. Every res block of the UNet is a dual
block whose residual is SPADE-modulated by the struct-cond features;
temporal modules sit in the middle block only. ``use_temporal=False`` is
the image-SR UNetModelDualcondV2 (a res / transformer / res middle block),
``use_spade=False`` makes every res block the stock SD ResBlock, and both
off are the stock ``UNetModel``.

``dropout`` acts only in training: a forward given ``dropout_seed`` (the
JAX modules' ``deterministic=False``) drops inside every res block, the
k-th res block of a call drawing its mask from seed + k; without a seed a
forward is deterministic whatever ``dropout`` is.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from mgldvsr_tpu_torch.core.schedules import timestep_embedding
from mgldvsr_tpu_torch.models.attention_blocks import QKVAttentionBlock, SpatialTransformer
from mgldvsr_tpu_torch.models.layers import (
    Downsample,
    UNetResBlock,
    Upsample,
    conv3x3,
    dropout_seeds,
    next_seed,
    norm_silu_conv,
    norm_silu_conv3x3,
    timestep_embed_mlp,
)
from mgldvsr_tpu_torch.models.spade import SPADE
from mgldvsr_tpu_torch.models.temporal import SpatialTemporalConv, TemporalAttention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """The UNet's widths and compute dtype. On the card ``dtype`` is
    bfloat16 or float32: fp16 is not supported on the card, because the
    attention wrapper has no fp16 kernel and raises on it; use bf16 or fp32.
    On the CPU every dtype runs through the plain versions."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (4, 2, 1)
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    semb_channels: int = 256
    num_frames: int = 5
    dropout: float = 0.0
    # False: 1x1-conv proj_in / proj_out in the spatial transformers
    use_linear_in_transformer: bool = True
    use_temporal: bool = True  # False: the image-SR UNetModelDualcondV2
    use_spade: bool = True     # False: stock res blocks (with use_temporal=False, UNetModel)
    # rematerialise each res block and transformer in the backward pass
    # (torch.utils.checkpoint) instead of keeping their activations
    use_checkpoint: bool = False
    dtype: torch.dtype = torch.float32


class DualResBlock(UNetResBlock):
    """UNet res block whose residual branch is SPADE-modulated before the
    skip add (upstream ResBlockDual)."""

    def __init__(self, cin: int, cout: int, emb_channels: int, semb_channels: int,
                 dtype=torch.float32, dropout: float = 0.0):
        super().__init__(cin, cout, emb_channels, dtype, dropout)
        self.spade = SPADE(cout, semb_channels, dtype=dtype)

    def forward(self, x, emb, s_cond, dropout_seed=None):
        h = self.spade(self.residual(x, emb, dropout_seed), s_cond)
        return self.skip_connection(x) + h


def _call(layer: nn.Module, remat: bool, *args):
    """``layer(*args)``, rematerialised in the backward pass when ``remat``
    and autograd is recording (non-reentrant ``torch.utils.checkpoint``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


def _run(block: nn.ModuleList, h, emb, context, s_cond, remat: bool = False,
         seeds: Optional[Iterator[int]] = None):
    """The layers of one block in order; with ``remat`` the res blocks and
    spatial transformers are rematerialised (the JAX package's
    ``nn.remat`` set). Each res block takes the next of ``seeds``."""
    for layer in block:
        seed = next_seed(seeds) if isinstance(layer, UNetResBlock) else None
        if isinstance(layer, DualResBlock):
            h = _call(layer, remat, h, emb, s_cond, seed)
        elif isinstance(layer, UNetResBlock):
            h = _call(layer, remat, h, emb, seed)
        elif isinstance(layer, SpatialTransformer):
            h = _call(layer, remat, h, context)
        else:
            h = layer(h)
    return h


class InflatedUNetDualCond(nn.Module):
    """eps = f(x_t [N,C,H,W], t [N], context [B,77,D], struct_cond dict);
    ``struct_cond`` is not read when ``use_spade`` is off."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        mc = cfg.model_channels
        emb_dim = mc * 4
        self.time_embed = timestep_embed_mlp(mc, emb_dim)

        def res(cin, cout):
            if cfg.use_spade:
                return DualResBlock(cin, cout, emb_dim, cfg.semb_channels, dt, cfg.dropout)
            return UNetResBlock(cin, cout, emb_dim, dt, cfg.dropout)

        def transformer(ch):
            return SpatialTransformer(ch, ch // cfg.num_head_channels, cfg.num_head_channels,
                                      cfg.transformer_depth, cfg.context_dim, dt,
                                      cfg.use_linear_in_transformer)

        blocks = [nn.ModuleList([conv3x3(cfg.in_channels, mc)])]
        chans = [mc]
        ch = mc
        ds = 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(transformer(ch))
                blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)

        heads_mid = ch // cfg.num_head_channels
        if cfg.use_temporal:
            self.middle_block = nn.ModuleList([
                res(ch, ch),
                SpatialTemporalConv(ch, cfg.num_frames),
                transformer(ch),
                TemporalAttention(ch, cfg.num_frames, heads_mid, cfg.num_head_channels),
                res(ch, ch),
                SpatialTemporalConv(ch, cfg.num_frames),
            ])
        else:
            self.middle_block = nn.ModuleList([res(ch, ch), transformer(ch), res(ch, ch)])

        blocks = []
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(transformer(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                blocks.append(nn.ModuleList(layers))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = norm_silu_conv3x3(ch, cfg.out_channels, dt)

    def forward(self, x, timesteps, context, struct_cond: Optional[Dict[str, torch.Tensor]],
                dropout_seed: Optional[int] = None):
        emb = self.time_embed(timestep_embedding(timesteps, self.cfg.model_channels))
        remat = self.cfg.use_checkpoint
        seeds = dropout_seeds(dropout_seed)
        hs = []
        h = x
        for block in self.input_blocks:
            h = _run(block, h, emb, context, struct_cond, remat, seeds)
            hs.append(h)
        h = _run(self.middle_block, h, emb, context, struct_cond, remat, seeds)
        for block in self.output_blocks:
            h = torch.cat([h, hs.pop().to(h.dtype)], dim=1)
            h = _run(block, h, emb, context, struct_cond, remat, seeds)
        return norm_silu_conv(self.out[0], self.out[2], h).float()


@dataclasses.dataclass(frozen=True)
class StructCondConfig:
    in_channels: int = 4
    model_channels: int = 256
    out_channels: int = 256
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (4, 2, 1)
    channel_mult: Sequence[int] = (1, 1, 2, 2)
    num_heads: int = 4
    dropout: float = 0.0  # in training only, as UNetConfig's
    num_frames: int = 5
    use_checkpoint: bool = False  # rematerialise each res block (see UNetConfig)
    dtype: torch.dtype = torch.float32


class StructCondEncoder(nn.Module):
    """Timestep-aware half-UNet over the LQ latent -> SPADE conditioning
    dict keyed by spatial width."""

    def __init__(self, cfg: StructCondConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        mc = cfg.model_channels
        emb_dim = mc * 4
        self.time_embed = timestep_embed_mlp(mc, emb_dim)
        blocks = [nn.ModuleList([conv3x3(cfg.in_channels, mc)])]
        self._tap_after = []  # input-block indices whose output feeds fea_tran
        ch = mc
        ds = 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [UNetResBlock(ch, mult * mc, emb_dim, dt, cfg.dropout)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(QKVAttentionBlock(ch, cfg.num_heads, dt))
                blocks.append(nn.ModuleList(layers))
            if level != len(cfg.channel_mult) - 1:
                self._tap_after.append(len(blocks) - 1)
                blocks.append(nn.ModuleList([Downsample(ch)]))
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([
            UNetResBlock(ch, ch, emb_dim, dt, cfg.dropout),
            QKVAttentionBlock(ch, cfg.num_heads, dt),
            UNetResBlock(ch, ch, emb_dim, dt, cfg.dropout),
        ])
        tap_channels = [cfg.channel_mult[i] * mc for i in range(len(cfg.channel_mult) - 1)]
        self.fea_tran = nn.ModuleList([
            UNetResBlock(c, cfg.out_channels, emb_dim, dt, cfg.dropout)
            for c in tap_channels + [ch]])

    def forward(self, x, timesteps, dropout_seed: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
        emb = self.time_embed(timestep_embedding(timesteps, self.cfg.model_channels))
        remat = self.cfg.use_checkpoint
        seeds = dropout_seeds(dropout_seed)
        feats = []
        h = x
        for idx, block in enumerate(self.input_blocks):
            h = _run(block, h, emb, None, None, remat, seeds)
            if idx in self._tap_after:
                feats.append(h)
        h = _run(self.middle_block, h, emb, None, None, remat, seeds)
        feats.append(h)
        results: Dict[str, torch.Tensor] = {}
        for f, proj in zip(feats, self.fea_tran):
            out = _call(proj, remat, f, emb, next_seed(seeds))
            results[str(out.shape[-1])] = out
        return results


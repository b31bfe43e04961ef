"""JAX parameter trees -> port state dicts.

One function per tower, each the exact inverse of the JAX package's
converter of that tower (``mgldvsr_tpu/io/ckpt_convert.py``):
``convert_unet``, ``convert_structcond``, ``convert_autoencoder(video=True,
fusion=True)``, ``convert_openclip_text`` and ``convert_raft``. The input is
the tree as nested dicts of numpy arrays (with or without its top
``"params"`` level); the output loads into the port's module with
``load_state_dict(strict=True)``.

Layouts: flax conv kernels [kh,kw,I,O] -> torch [O,I,kh,kw]; 3-D
[kt,kh,kw,I,O] -> [O,I,kt,kh,kw]; dense [I,O] -> [O,I]; the struct-cond
qkv goes back from [3,H,d] to upstream's head-interleaved [H,3,d] order.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from mgldvsr_tpu_torch.flow.raft import RAFTConfig
from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig
from mgldvsr_tpu_torch.models.unet import StructCondConfig, UNetConfig
from mgldvsr_tpu_torch.models.vae import VAEConfig

Tree = Mapping[str, Any]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _params(tree: Tree) -> Tree:
    return tree["params"] if "params" in tree else tree


class _SD:
    """Prefix-scoped writer into a flat state dict (the mirror of the JAX
    converters' ``SDGet`` reader)."""

    def __init__(self, sd: Dict[str, torch.Tensor], prefix: str = ""):
        self.sd = sd
        self.prefix = prefix

    def scope(self, sub: str) -> "_SD":
        return _SD(self.sd, f"{self.prefix}{sub}.")

    def raw(self, key: str, value) -> None:
        self.sd[f"{self.prefix}{key}"] = _tensor(value)

    def conv(self, key: str, p: Tree) -> None:
        k = np.asarray(p["kernel"])
        perm = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2), 3: (2, 1, 0)}[k.ndim]
        self.raw(f"{key}.weight", k.transpose(perm))
        if "bias" in p:
            self.raw(f"{key}.bias", p["bias"])

    def linear(self, key: str, p: Tree) -> None:
        self.raw(f"{key}.weight", np.asarray(p["kernel"]).T)
        if "bias" in p:
            self.raw(f"{key}.bias", p["bias"])

    def norm(self, key: str, p: Tree) -> None:
        self.raw(f"{key}.weight", p["scale"])
        self.raw(f"{key}.bias", p["bias"])


# -- shared blocks -----------------------------------------------------------


def _resblock(g: _SD, p: Tree, dual: bool) -> None:
    g.norm("in_layers.0", p["GroupNorm_0"])
    g.conv("in_layers.2", p["conv1"])
    g.linear("emb_layers.1", p["emb_proj"])
    g.norm("out_layers.0", p["GroupNorm_1"])
    g.conv("out_layers.3", p["conv2"])
    if "skip" in p:
        g.conv("skip_connection", p["skip"])
    if dual:
        s = g.scope("spade")
        sp = p["spade"]
        s.norm("param_free_norm", sp["GroupNorm_0"])
        s.conv("mlp_shared.0", sp["mlp_shared"])
        s.conv("mlp_gamma", sp["mlp_gamma"])
        s.conv("mlp_beta", sp["mlp_beta"])


def _cross_attn(g: _SD, p: Tree) -> None:
    for name in ("to_q", "to_k", "to_v"):
        g.linear(name, p[name])
    g.linear("to_out.0", p["to_out"])


def _transformer(g: _SD, p: Tree, depth: int) -> None:
    g.norm("norm", p["GroupNorm_0"])
    g.linear("proj_in", p["proj_in"])
    g.linear("proj_out", p["proj_out"])
    for d in range(depth):
        b = g.scope(f"transformer_blocks.{d}")
        bp = p[f"block_{d}"]
        for n in ("norm1", "norm2", "norm3"):
            b.norm(n, bp[n])
        _cross_attn(b.scope("attn1"), bp["attn1"])
        _cross_attn(b.scope("attn2"), bp["attn2"])
        b.linear("ff.net.0.proj", bp["ff"]["proj_in"])
        b.linear("ff.net.2", bp["ff"]["proj_out"])


def _stconv(g: _SD, p: Tree) -> None:
    g.conv("temporal_conv", p["temporal_conv"])
    g.raw("temporal_alpha", np.asarray(p["alpha"]).reshape(1))


def _tattn(g: _SD, p: Tree) -> None:
    g.norm("norm", p["norm"])
    a = g.scope("temporal_attn")
    for name in ("to_q", "to_k", "to_v"):
        a.linear(name, p[name])
    a.linear("to_out.0", p["to_out"])
    g.raw("temporal_alpha", np.asarray(p["alpha"]).reshape(1))


def _qkv_legacy(g: _SD, p: Tree, channels: int, num_heads: int) -> None:
    d = channels // num_heads
    w = np.asarray(p["qkv"]["kernel"]).T                     # [3C, C], [3,H,d] rows
    w = w.reshape(3, num_heads, d, channels).transpose(1, 0, 2, 3)
    b = np.asarray(p["qkv"]["bias"]).reshape(3, num_heads, d).transpose(1, 0, 2)
    g.norm("norm", p["GroupNorm_0"])
    g.raw("qkv.weight", w.reshape(3 * channels, channels)[..., None])
    g.raw("qkv.bias", b.reshape(3 * channels))
    g.raw("proj_out.weight", np.asarray(p["proj_out"]["kernel"]).T[..., None])
    g.raw("proj_out.bias", p["proj_out"]["bias"])


def _time_embed(g: _SD, p: Tree) -> None:
    g.linear("0", p["fc1"])
    g.linear("2", p["fc2"])


# -- towers ------------------------------------------------------------------


def unet_state_dict(tree: Tree, cfg: UNetConfig = UNetConfig()) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_unet`` (dual, temporal)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    _time_embed(g.scope("time_embed"), p["time_embed"])
    g.conv("input_blocks.0.0", p["conv_in"])
    g.norm("out.0", p["GroupNorm_0"])
    g.conv("out.2", p["conv_out"])
    depth = cfg.transformer_depth
    idx, ds = 1, 1
    for level in range(len(cfg.channel_mult)):
        for nr in range(cfg.num_res_blocks):
            blk = g.scope(f"input_blocks.{idx}")
            _resblock(blk.scope("0"), p[f"in_{level}_{nr}_res"], dual=True)
            if ds in cfg.attention_resolutions:
                _transformer(blk.scope("1"), p[f"in_{level}_{nr}_attn"], depth)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            g.conv(f"input_blocks.{idx}.0.op", p[f"in_{level}_down"]["op"])
            idx += 1
            ds *= 2
    mid = g.scope("middle_block")
    _resblock(mid.scope("0"), p["mid_res1"], dual=True)
    _stconv(mid.scope("1"), p["mid_stconv1"])
    _transformer(mid.scope("2"), p["mid_attn"], depth)
    _tattn(mid.scope("3"), p["mid_tattn"])
    _resblock(mid.scope("4"), p["mid_res2"], dual=True)
    _stconv(mid.scope("5"), p["mid_stconv2"])
    idx = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            blk = g.scope(f"output_blocks.{idx}")
            _resblock(blk.scope("0"), p[f"out_{level}_{i}_res"], dual=True)
            sub = 1
            if ds in cfg.attention_resolutions:
                _transformer(blk.scope(str(sub)), p[f"out_{level}_{i}_attn"], depth)
                sub += 1
            if level and i == cfg.num_res_blocks:
                blk.conv(f"{sub}.conv", p[f"out_{level}_up"]["conv"])
                ds //= 2
            idx += 1
    return sd


def structcond_state_dict(tree: Tree, cfg: StructCondConfig = StructCondConfig()
                          ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_structcond``."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    _time_embed(g.scope("time_embed"), p["time_embed"])
    g.conv("input_blocks.0.0", p["conv_in"])
    idx, ds = 1, 1
    for level, mult in enumerate(cfg.channel_mult):
        ch = mult * cfg.model_channels
        for nr in range(cfg.num_res_blocks):
            blk = g.scope(f"input_blocks.{idx}")
            _resblock(blk.scope("0"), p[f"in_{level}_{nr}_res"], dual=False)
            if ds in cfg.attention_resolutions:
                _qkv_legacy(blk.scope("1"), p[f"in_{level}_{nr}_attn"], ch, cfg.num_heads)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            g.conv(f"input_blocks.{idx}.0.op", p[f"in_{level}_down"]["op"])
            idx += 1
            ds *= 2
    mid = g.scope("middle_block")
    ch = cfg.channel_mult[-1] * cfg.model_channels
    _resblock(mid.scope("0"), p["mid_res1"], dual=False)
    _qkv_legacy(mid.scope("1"), p["mid_attn"], ch, cfg.num_heads)
    _resblock(mid.scope("2"), p["mid_res2"], dual=False)
    for i in range(len(cfg.channel_mult)):
        _resblock(g.scope(f"fea_tran.{i}"), p[f"fea_tran_{i}"], dual=False)
    return sd


def _vae_resnet(g: _SD, p: Tree) -> None:
    g.norm("norm1", p["GroupNorm_0"])
    g.conv("conv1", p["conv1"])
    g.norm("norm2", p["GroupNorm_1"])
    g.conv("conv2", p["conv2"])
    if "nin_shortcut" in p:
        g.conv("nin_shortcut", p["nin_shortcut"])


def _vae_attn(g: _SD, p: Tree) -> None:
    g.norm("norm", p["GroupNorm_0"])
    for name in ("q", "k", "v", "proj_out"):
        g.conv(name, p[name])


def _simple_resblock(g: _SD, p: Tree) -> None:
    g.norm("norm1", p["GroupNorm_0"])
    g.conv("conv1", p["conv1"])
    g.norm("norm2", p["GroupNorm_1"])
    g.conv("conv2", p["conv2"])
    if "conv_out" in p:
        g.conv("conv_out", p["conv_out"])


def vae_state_dict(tree: Tree, cfg: VAEConfig = VAEConfig(num_frames=5, enable_fusion=True)
                   ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_autoencoder(video=True, fusion=True)``."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    ep, enc = p["encoder"], g.scope("encoder")
    enc.conv("conv_in", ep["conv_in"])
    curr_res = cfg.resolution
    for i in range(len(cfg.ch_mult)):
        for j in range(cfg.num_res_blocks):
            _vae_resnet(enc.scope(f"down.{i}.block.{j}"), ep[f"down_{i}_block_{j}"])
            if curr_res in cfg.attn_resolutions:
                _vae_attn(enc.scope(f"down.{i}.attn.{j}"), ep[f"down_{i}_attn_{j}"])
        if i != len(cfg.ch_mult) - 1:
            enc.conv(f"down.{i}.downsample.conv", ep[f"down_{i}_downsample"]["conv"])
            curr_res //= 2
    _vae_resnet(enc.scope("mid.block_1"), ep["mid_block_1"])
    _vae_attn(enc.scope("mid.attn_1"), ep["mid_attn_1"])
    _vae_resnet(enc.scope("mid.block_2"), ep["mid_block_2"])
    enc.norm("norm_out", ep["GroupNorm_0"])
    enc.conv("conv_out", ep["conv_out"])

    dp, dec = p["decoder"], g.scope("decoder")
    dec.conv("conv_in", dp["conv_in"])
    _vae_resnet(dec.scope("mid.block_1"), dp["mid_block_1"])
    _stconv(dec.scope("temporal_mixing"), dp["mid_temporal"])
    _vae_attn(dec.scope("mid.attn_1"), dp["mid_attn_1"])
    _vae_resnet(dec.scope("mid.block_2"), dp["mid_block_2"])
    curr_res = cfg.resolution // 2 ** (len(cfg.ch_mult) - 1)
    for i in reversed(range(len(cfg.ch_mult))):
        for j in range(cfg.num_res_blocks + 1):
            _vae_resnet(dec.scope(f"up.{i}.block.{j}"), dp[f"up_{i}_block_{j}"])
            _stconv(dec.scope(f"up.{i}.temporal_mixing.{j}"), dp[f"up_{i}_temporal_{j}"])
            if curr_res in cfg.attn_resolutions:
                _vae_attn(dec.scope(f"up.{i}.attn.{j}"), dp[f"up_{i}_attn_{j}"])
        if i in (1, 2):
            fp, f = dp[f"fusion_layer_{i}"], dec.scope(f"fusion_layer_{i}")
            _simple_resblock(f.scope("encode_enc_1"), fp["encode_enc_1"])
            _simple_resblock(f.scope("encode_enc_3"), fp["encode_enc_3"])
            k = 0
            while f"encode_enc_2_{k}" in fp:
                rdb, rp = f.scope(f"encode_enc_2.{k}"), fp[f"encode_enc_2_{k}"]
                for c in range(1, 6):
                    rdb.conv(f"conv{c}", rp[f"conv{c}"])
                k += 1
        if i != 0:
            dec.conv(f"up.{i}.upsample.conv", dp[f"up_{i}_upsample"]["conv"])
            curr_res *= 2
    dec.norm("norm_out", dp["GroupNorm_0"])
    dec.conv("conv_out", dp["conv_out"])
    g.conv("quant_conv", p["quant_conv"])
    g.conv("post_quant_conv", p["post_quant_conv"])
    return sd


def clip_state_dict(tree: Tree, cfg: CLIPTextConfig = CLIPTextConfig()
                    ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_openclip_text``."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    g.raw("token_embedding.weight", p["token_embedding"])
    g.raw("positional_embedding", p["positional_embedding"])
    g.norm("ln_final", p["ln_final"])
    n_blocks = cfg.layers - (1 if cfg.layer == "penultimate" else 0)
    for i in range(n_blocks):
        b, bp = g.scope(f"transformer.resblocks.{i}"), p[f"resblock_{i}"]
        b.norm("ln_1", bp["ln_1"])
        b.norm("ln_2", bp["ln_2"])
        b.raw("attn.in_proj_weight", np.asarray(bp["attn_in_proj"]["kernel"]).T)
        b.raw("attn.in_proj_bias", bp["attn_in_proj"]["bias"])
        b.linear("attn.out_proj", bp["attn_out_proj"])
        b.linear("mlp.c_fc", bp["mlp_c_fc"])
        b.linear("mlp.c_proj", bp["mlp_c_proj"])
    return sd


def _frozen_bn(g: _SD, p: Tree) -> None:
    g.raw("weight", p["scale"])
    g.raw("bias", p["bias"])
    g.raw("running_mean", p["mean"])
    g.raw("running_var", p["var"])


def _raft_encoder(g: _SD, p: Tree, batch_norm: bool) -> None:
    g.conv("conv1", p["conv1"])
    g.conv("conv2", p["conv2"])
    if batch_norm:
        _frozen_bn(g.scope("norm1"), p["norm1"])
    for layer in (1, 2, 3):
        for blk in (0, 1):
            r, rp = g.scope(f"layer{layer}.{blk}"), p[f"layer{layer}_{blk}"]
            r.conv("conv1", rp["conv1"])
            r.conv("conv2", rp["conv2"])
            if batch_norm:
                _frozen_bn(r.scope("norm1"), rp["norm1"])
                _frozen_bn(r.scope("norm2"), rp["norm2"])
            if "downsample" in rp:
                r.conv("downsample.0", rp["downsample"])
                if batch_norm:
                    _frozen_bn(r.scope("downsample.1"), rp["norm3"])


def raft_state_dict(tree: Tree, cfg: RAFTConfig = RAFTConfig()) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_raft``."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    _raft_encoder(g.scope("fnet"), p["fnet"], batch_norm=False)
    _raft_encoder(g.scope("cnet"), p["cnet"], batch_norm=True)
    up, u = p["update_scan"]["update_block"], g.scope("update_block")
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        u.conv(f"encoder.{name}", up["encoder"][name])
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        u.conv(f"gru.{name}", up["gru"][name])
    u.conv("flow_head.conv1", up["flow_head_conv1"])
    u.conv("flow_head.conv2", up["flow_head_conv2"])
    u.conv("mask.0", up["mask_conv1"])
    u.conv("mask.2", up["mask_conv2"])
    return sd


def pipeline_state_dicts(params: Tree, cfg) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX pipeline's ``{"unet", "structcond", "vae", "clip", "raft"}``
    params -> one port state dict per tower (``cfg``: a port
    ``PipelineConfig``)."""
    return {
        "unet": unet_state_dict(params["unet"], cfg.unet),
        "structcond": structcond_state_dict(params["structcond"], cfg.structcond),
        "vae": vae_state_dict(params["vae"], cfg.vae),
        "clip": clip_state_dict(params["clip"], cfg.clip),
        "raft": raft_state_dict(params["raft"], cfg.raft),
    }

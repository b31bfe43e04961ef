"""JAX parameter trees -> port state dicts.

One function per tower, each the exact inverse of the JAX package's
converter of that tower (``mgldvsr_tpu/io/ckpt_convert.py``):
``convert_unet``, ``convert_structcond``, ``convert_autoencoder(video=True,
fusion=True)``, ``convert_openclip_text`` and ``convert_raft``, of the
stage-2 loss networks ``convert_lpips``, ``convert_discriminator`` and
``convert_spynet``, of FID's ``convert_inception``, of the CLIP image
tower's ``convert_clip_image``, and of the 21 converters of MaskFlownet and
the BasicSR heritage (``convert_maskflownet``, ``convert_rrdbnet`` ...
``convert_stylegan2_discriminator``; the section at the end). The JAX
package has no converter for the noisy-latent classifier, the other
alternate encoders and the U-Net discriminator: :func:`classifier_state_dict`,
:func:`encoders_state_dict` and :func:`unet_discriminator_sn_state_dict`
write the port's keys, which follow the reference's module names. The input is
the tree as nested dicts of numpy arrays (with or without its top
``"params"`` level); the output loads into the port's module with
``load_state_dict(strict=True)``.

Layouts: flax conv kernels [kh,kw,I,O] -> torch [O,I,kh,kw]; 3-D
[kt,kh,kw,I,O] -> [O,I,kt,kh,kw]; dense [I,O] -> [O,I]; the struct-cond
qkv goes back from [3,H,d] to upstream's head-interleaved [H,3,d] order.

The same maps, run on a tree that holds paths instead of arrays
(:func:`jax_paths`), say which JAX leaf each torch key comes from and which
torch axis the leaf's last (output) axis becomes: the tensor-parallel rule
reads the JAX path.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from mgldvsr_tpu_torch.flow.raft import RAFTConfig
from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig
from mgldvsr_tpu_torch.models.heritage.misc_archs import (
    ECB_DEPTH_MULTIPLIER,
    EDGE_KINDS,
    edge_mask,
)
from mgldvsr_tpu_torch.models.unet import StructCondConfig, UNetConfig
from mgldvsr_tpu_torch.models.vae import VAEConfig

Tree = Mapping[str, Any]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _params(tree: Tree) -> Tree:
    return tree["params"] if "params" in tree else tree


class _Trace:
    """A stand-in for a JAX parameter tree that holds paths instead of
    arrays. Every node exists but ``params`` (the maps then take the tree
    as it is), so optional branches are written too; :meth:`_SD.raw` keeps
    only the keys the module has (``keys``), each as its JAX path and the
    torch axis of the leaf's last axis (in ``found``)."""

    def __init__(self, path: Tuple[str, ...], keys, found: dict):
        self.path, self.keys, self.found = path, keys, found

    def __getitem__(self, key: str) -> "_Trace":
        return _Trace(self.path + (key,), self.keys, self.found)

    def __contains__(self, key: str) -> bool:
        return key != "params"


def _conv_layout(k: np.ndarray) -> np.ndarray:
    return k.transpose({4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2), 3: (2, 1, 0)}[k.ndim])


class _SD:
    """Prefix-scoped writer into a flat state dict (the mirror of the JAX
    converters' ``SDGet`` reader)."""

    def __init__(self, sd: Dict[str, torch.Tensor], prefix: str = ""):
        self.sd = sd
        self.prefix = prefix

    def scope(self, sub: str) -> "_SD":
        return _SD(self.sd, f"{self.prefix}{sub}.")

    def raw(self, key: str, value, layout=None, out_axis: int = -1) -> None:
        """``value`` (a leaf), through ``layout`` (the leaf -> the torch
        layout) where given; ``out_axis``: the torch axis its last axis
        becomes."""
        key = f"{self.prefix}{key}"
        if isinstance(value, _Trace):
            if key in value.keys:
                value.found[key] = (value.path, out_axis)
            return
        self.sd[key] = _tensor(value if layout is None else layout(np.asarray(value)))

    def conv(self, key: str, p: Tree) -> None:
        self.raw(f"{key}.weight", p["kernel"], _conv_layout, out_axis=0)
        if "bias" in p:
            self.raw(f"{key}.bias", p["bias"])

    def linear(self, key: str, p: Tree) -> None:
        self.raw(f"{key}.weight", p["kernel"], np.transpose, out_axis=0)
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


def _linear_or_conv(g: _SD, key: str, p: Tree) -> None:
    """A dense kernel [I, O] or a 1x1 conv kernel [1, 1, I, O] (the
    transformers' projections without ``use_linear_in_transformer``)."""
    g.raw(f"{key}.weight", p["kernel"], lambda k: k.T if k.ndim == 2 else _conv_layout(k),
          out_axis=0)
    if "bias" in p:
        g.raw(f"{key}.bias", p["bias"])


def _transformer(g: _SD, p: Tree, depth: int) -> None:
    g.norm("norm", p["GroupNorm_0"])
    _linear_or_conv(g, "proj_in", p["proj_in"])
    _linear_or_conv(g, "proj_out", p["proj_out"])
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
    g.raw("temporal_alpha", p["alpha"], _one)


def _tattn(g: _SD, p: Tree) -> None:
    g.norm("norm", p["norm"])
    a = g.scope("temporal_attn")
    for name in ("to_q", "to_k", "to_v"):
        a.linear(name, p[name])
    a.linear("to_out.0", p["to_out"])
    g.raw("temporal_alpha", p["alpha"], _one)


def _one(a: np.ndarray) -> np.ndarray:
    return a.reshape(1)


def _qkv_legacy(g: _SD, p: Tree, channels: int, num_heads: int) -> None:
    d = channels // num_heads

    def weight(k):  # [C, 3C] -> [3C, C, 1], the rows from [3,H,d] to [H,3,d]
        k = k.T.reshape(3, num_heads, d, channels).transpose(1, 0, 2, 3)
        return k.reshape(3 * channels, channels)[..., None]

    def bias(b):
        return b.reshape(3, num_heads, d).transpose(1, 0, 2).reshape(3 * channels)

    g.norm("norm", p["GroupNorm_0"])
    g.raw("qkv.weight", p["qkv"]["kernel"], weight, out_axis=0)
    g.raw("qkv.bias", p["qkv"]["bias"], bias)
    g.raw("proj_out.weight", p["proj_out"]["kernel"], lambda k: k.T[..., None], out_axis=0)
    g.raw("proj_out.bias", p["proj_out"]["bias"])


def _time_embed(g: _SD, p: Tree) -> None:
    g.linear("0", p["fc1"])
    g.linear("2", p["fc2"])


# -- towers ------------------------------------------------------------------


def unet_state_dict(tree: Tree, cfg: UNetConfig = UNetConfig()) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_unet(dual=cfg.use_spade,
    temporal=cfg.use_temporal)``."""
    p = _params(tree)
    dual = cfg.use_spade
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
            _resblock(blk.scope("0"), p[f"in_{level}_{nr}_res"], dual)
            if ds in cfg.attention_resolutions:
                _transformer(blk.scope("1"), p[f"in_{level}_{nr}_attn"], depth)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            g.conv(f"input_blocks.{idx}.0.op", p[f"in_{level}_down"]["op"])
            idx += 1
            ds *= 2
    mid = g.scope("middle_block")
    _resblock(mid.scope("0"), p["mid_res1"], dual)
    if cfg.use_temporal:
        _stconv(mid.scope("1"), p["mid_stconv1"])
        _transformer(mid.scope("2"), p["mid_attn"], depth)
        _tattn(mid.scope("3"), p["mid_tattn"])
        _resblock(mid.scope("4"), p["mid_res2"], dual)
        _stconv(mid.scope("5"), p["mid_stconv2"])
    else:
        _transformer(mid.scope("1"), p["mid_attn"], depth)
        _resblock(mid.scope("2"), p["mid_res2"], dual)
    idx = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            blk = g.scope(f"output_blocks.{idx}")
            _resblock(blk.scope("0"), p[f"out_{level}_{i}_res"], dual)
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
    """Inverse of ``convert_autoencoder(video=cfg.num_frames > 1,
    fusion=cfg.enable_fusion)``; the image ``AutoencoderKL`` is
    ``num_frames=1, enable_fusion=False``."""
    p = _params(tree)
    video = cfg.num_frames > 1
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
    if video:
        _stconv(dec.scope("temporal_mixing"), dp["mid_temporal"])
    _vae_attn(dec.scope("mid.attn_1"), dp["mid_attn_1"])
    _vae_resnet(dec.scope("mid.block_2"), dp["mid_block_2"])
    curr_res = cfg.resolution // 2 ** (len(cfg.ch_mult) - 1)
    for i in reversed(range(len(cfg.ch_mult))):
        for j in range(cfg.num_res_blocks + 1):
            _vae_resnet(dec.scope(f"up.{i}.block.{j}"), dp[f"up_{i}_block_{j}"])
            if video:
                _stconv(dec.scope(f"up.{i}.temporal_mixing.{j}"), dp[f"up_{i}_temporal_{j}"])
            if curr_res in cfg.attn_resolutions:
                _vae_attn(dec.scope(f"up.{i}.attn.{j}"), dp[f"up_{i}_attn_{j}"])
        if cfg.enable_fusion and i in (1, 2):
            fp, f = dp[f"fusion_layer_{i}"], dec.scope(f"fusion_layer_{i}")
            _simple_resblock(f.scope("encode_enc_1"), fp["encode_enc_1"])
            _simple_resblock(f.scope("encode_enc_3"), fp["encode_enc_3"])
            for k in range(cfg.num_fuse_block):
                rdb, rp = f.scope(f"encode_enc_2.{k}"), fp[f"encode_enc_2_{k}"]
                for c in range(1, 6):
                    rdb.conv(f"conv{c}", rp[f"conv{c}"])
        if i != 0:
            dec.conv(f"up.{i}.upsample.conv", dp[f"up_{i}_upsample"]["conv"])
            curr_res *= 2
    dec.norm("norm_out", dp["GroupNorm_0"])
    dec.conv("conv_out", dp["conv_out"])
    g.conv("quant_conv", p["quant_conv"])
    g.conv("post_quant_conv", p["post_quant_conv"])
    return sd


def multidim_temporal_conv_state_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    """The JAX ``MultiDimTemporalConv``'s params -> upstream's keys
    (``temporal_conv1``, ``temporal_conv2``, ``temporal_alpha``)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    g.conv("temporal_conv1", p["temporal_conv1"])
    g.conv("temporal_conv2", p["temporal_conv2"])
    g.raw("temporal_alpha", p["alpha"], _one)
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
        _clip_block(g.scope(f"transformer.resblocks.{i}"), p[f"resblock_{i}"])
    return sd


def _clip_block(b: _SD, bp: Tree) -> None:
    """A text or image tower's ``ResidualAttentionBlock``."""
    b.norm("ln_1", bp["ln_1"])
    b.norm("ln_2", bp["ln_2"])
    b.raw("attn.in_proj_weight", bp["attn_in_proj"]["kernel"], np.transpose, out_axis=0)
    b.raw("attn.in_proj_bias", bp["attn_in_proj"]["bias"])
    b.linear("attn.out_proj", bp["attn_out_proj"])
    b.linear("mlp.c_fc", bp["mlp_c_fc"])
    b.linear("mlp.c_proj", bp["mlp_c_proj"])


def _blocks(p: Tree, stem: str) -> int:
    return sum(1 for k in p if k.startswith(stem))


def clip_image_state_dict(tree: Tree, prefix: str = "visual.") -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_clip_image`` (OpenAI ``clip.visual``'s keys,
    under ``prefix``); its ``layers`` is the tree's count of blocks."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd, prefix)
    g.raw("conv1.weight", p["patch_embed"]["kernel"], _conv_layout, out_axis=0)
    g.raw("class_embedding", p["class_embedding"])
    g.raw("positional_embedding", p["positional_embedding"])
    g.norm("ln_pre", p["ln_pre"])
    g.norm("ln_post", p["ln_post"])
    if "proj" in p:
        g.raw("proj", p["proj"])
    for i in range(_blocks(p, "resblock_")):
        _clip_block(g.scope(f"transformer.resblocks.{i}"), p[f"resblock_{i}"])
    return sd


def encoders_state_dict(tree: Tree, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX tree of one of ``mgldvsr_tpu/models/encoders.py``'s modules
    -> the state dict of ``module``, its port (the class picks the map)."""
    from mgldvsr_tpu_torch.models import encoders as enc

    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    if isinstance(module, enc.ClassEmbedder):
        g.raw("embedding.weight", p["embedding"])
    elif isinstance(module, enc.TransformerTextEmbedder):
        g.raw("token_emb.weight", p["token_embedding"])
        g.raw("pos_emb.emb.weight", p["positional_embedding"])
        g.norm("norm", p["norm"])
        for i in range(_blocks(p, "block_")):
            _clip_block(g.scope(f"attn_layers.resblocks.{i}"), p[f"block_{i}"])
    elif isinstance(module, enc.SpatialRescaler):
        if "channel_mapper" in p:
            g.conv("channel_mapper", p["channel_mapper"])
    elif isinstance(module, enc.CLIPImageEncoder):
        sd.update(clip_image_state_dict(p, prefix=""))
    elif isinstance(module, enc.FrozenClipImageEmbedder):
        sd.update(clip_image_state_dict(p["visual"]))
        if "linear" in p:
            g.linear("linear", p["linear"])
    else:
        raise TypeError(f"encoders_state_dict: no map for {type(module).__name__}")
    return sd


def classifier_state_dict(tree: Tree, cfg) -> Dict[str, torch.Tensor]:
    """The JAX ``NoisyLatentClassifier``'s tree -> the port's state dict
    (``cfg``: the port's ``ClassifierConfig``): the UNet's names for the
    trunk (``time_embed``, ``input_blocks``, ``middle_block``; the
    attention blocks' qkv in upstream's head-interleaved order) and
    ``out`` for the head."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    mc = cfg.model_channels
    _time_embed(g.scope("time_embed"), p["time_embed"])
    g.conv("input_blocks.0.0", p["conv_in"])
    idx, ds = 1, 1
    for level, mult in enumerate(cfg.channel_mult):
        for nr in range(cfg.num_res_blocks):
            blk = g.scope(f"input_blocks.{idx}")
            _resblock(blk.scope("0"), p[f"in_{level}_{nr}_res"], False)
            if ds in cfg.attention_resolutions:
                _qkv_legacy(blk.scope("1"), p[f"in_{level}_{nr}_attn"], mult * mc,
                            cfg.num_heads)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            g.conv(f"input_blocks.{idx}.0.op", p[f"in_{level}_down"]["op"])
            idx += 1
            ds *= 2
    ch = cfg.channel_mult[-1] * mc
    mid = g.scope("middle_block")
    _resblock(mid.scope("0"), p["mid_res1"], False)
    _qkv_legacy(mid.scope("1"), p["mid_attn"], ch, cfg.num_heads)
    _resblock(mid.scope("2"), p["mid_res2"], False)
    if cfg.pool == "attention":
        o = g.scope("out")
        o.raw("positional_embedding", p["pool"]["pos_embed"])
        for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
            o.linear(name, p["pool"][name])
    elif cfg.pool == "adaptive":
        g.linear("out", p["head"])
    else:
        g.linear("out.0", p["head_fc1"])
        g.linear("out.2", p["head_fc2"])
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


# torchvision VGG16 ``features`` indices of the 13 convs, by stage
_VGG16_FEATURE_IDX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))


def lpips_state_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_lpips`` (taming's ``net.slice{s}.{idx}`` and
    ``lin{i}.model.1``)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    for stage, idxs in enumerate(_VGG16_FEATURE_IDX):
        for j, idx in enumerate(idxs):
            g.conv(f"net.slice{stage + 1}.{idx}", p["vgg"][f"conv{stage + 1}_{j + 1}"])
    for i in range(len(_VGG16_FEATURE_IDX)):
        g.conv(f"lin{i}.model.1", p[f"lin{i}"])
    return sd


def discriminator_state_dict(tree: Tree, n_layers: int = 3) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_discriminator``: ``{"params", "batch_stats"}`` ->
    taming's ``main.{i}``, the BatchNorms with ``running_mean`` and
    ``running_var``."""
    p, stats = tree["params"], tree["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    g.conv("main.0", p["conv0"])
    for n in range(1, n_layers + 1):
        idx = 2 + 3 * (n - 1)
        g.conv(f"main.{idx}", p[f"conv{n}"])
        g.norm(f"main.{idx + 1}", p[f"bn{n}"])
        g.raw(f"main.{idx + 1}.running_mean", stats[f"bn{n}"]["mean"])
        g.raw(f"main.{idx + 1}.running_var", stats[f"bn{n}"]["var"])
    g.conv(f"main.{2 + 3 * n_layers}", p["conv_out"])
    return sd


def spynet_state_dict(tree: Tree, levels: int = 6) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_spynet`` (basicsr's
    ``basic_module.{i}.basic_module.{2j}``)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    for i in range(levels):
        m = g.scope(f"basic_module.{i}.basic_module")
        for j in range(5):
            m.conv(str(2 * j), p[f"basic_module{i}"][f"conv{j}"])
    return sd


def inception_state_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_inception``: every ``{"conv", "bn"}`` node of the
    tree becomes the pt_inception quintet ``<path>.conv.weight`` and
    ``<path>.bn.{weight,bias,running_mean,running_var}`` (the FID tower holds
    no ``fc`` or ``AuxLogits``)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(g: _SD, node: Tree) -> None:
        if "conv" in node:
            g.raw("conv.weight", node["conv"]["kernel"], _conv_layout, out_axis=0)
            _frozen_bn(g.scope("bn"), node["bn"])
            return
        for name, child in node.items():
            walk(g.scope(name), child)

    walk(_SD(sd), _params(tree))
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


def jax_paths(tower: str, module: torch.nn.Module) -> Dict[str, Tuple[Tuple[str, ...], int]]:
    """Where each entry of ``module``'s state dict comes from in the JAX
    state: ``{torch key: (JAX path, torch axis of the leaf's last axis)}``,
    from this module's maps run on a tree of paths. ``tower`` is the JAX
    state's name for the module (``unet``, ``structcond``, ``vae``,
    ``clip``, ``raft``; stage 2's ``lpips``, ``spynet`` and ``disc``), and
    heads every path. Raises where a key has no JAX leaf."""
    from mgldvsr_tpu_torch.models.discriminator import FlaxBatchNorm

    keys = set(module.state_dict())
    found: dict = {}
    tree = _Trace((tower,), keys, found)
    cfg = getattr(module, "cfg", None)
    maps = {
        "unet": lambda: unet_state_dict(tree, cfg),
        "structcond": lambda: structcond_state_dict(tree, cfg),
        "vae": lambda: vae_state_dict(tree, cfg),
        "clip": lambda: clip_state_dict(tree, cfg),
        "raft": lambda: raft_state_dict(tree, cfg),
        "lpips": lambda: lpips_state_dict(tree),
        "spynet": lambda: spynet_state_dict(tree, len(module.basic_module)),
        "disc": lambda: discriminator_state_dict(tree, sum(
            isinstance(m, FlaxBatchNorm) for m in module.modules())),
    }
    maps[tower]()
    missing = keys - set(found)
    if missing:
        raise KeyError(f"jax_paths({tower!r}): no JAX leaf for {sorted(missing)[:5]}")
    return found


# -- training state ------------------------------------------------------------


def _merge_trees(base: Tree, over: Tree) -> Dict[str, Any]:
    """Deep merge of nested dicts, ``over`` winning."""
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
            out[k] = _merge_trees(out[k], v)
        else:
            out[k] = v
    return out


def _find(obj, fields):
    """The first node of a tree of NamedTuples/tuples/lists with all of
    ``fields`` as attributes."""
    if all(hasattr(obj, f) for f in fields):
        return obj
    if isinstance(obj, (tuple, list)):
        for item in obj:
            found = _find(item, fields)
            if found is not None:
                return found
    return None


def _trainable_tensors(partial: Tree, frozen: Tree, cfg) -> Dict[str, torch.Tensor]:
    """A JAX tree over the trainable leaves only (params, a moment, an
    accumulator) -> port ``tower.name`` tensors: the tree is completed with
    the frozen leaves, converted per tower, and cut back to the trainables."""
    from mgldvsr_tpu_torch.train.trainer import TRAIN_TOWERS, is_trainable

    converters = {"unet": lambda t: unet_state_dict(t, cfg.unet),
                  "structcond": lambda t: structcond_state_dict(t, cfg.structcond)}
    out = {}
    for tower in TRAIN_TOWERS:
        full = _merge_trees(_params(frozen[tower]) if tower in frozen else {},
                            _params(partial[tower]))
        for name, v in converters[tower](full).items():
            if is_trainable(f"{tower}.{name}"):
                out[f"{tower}.{name}"] = v
    return out


def _opt_state(opt, convert, ocfg, device) -> dict:
    """An optax ``[MultiSteps(]adam[w])`` state -> ``optim.init_opt_state``'s
    layout for the port's ``ocfg`` (the first moment in its mu dtype);
    ``convert`` maps a JAX tree of the parameters to port tensors."""
    adam = _find(opt, ("count", "mu", "nu"))
    multi = _find(opt, ("mini_step", "gradient_step", "acc_grads"))

    def onto(tree, dtype=torch.float32):
        return {k: v.to(device=device, dtype=dtype) for k, v in convert(tree).items()}

    return {
        "count": int(np.asarray(adam.count)),
        "mini_step": int(np.asarray(multi.mini_step)) if multi is not None else 0,
        "gradient_step": (int(np.asarray(multi.gradient_step)) if multi is not None
                          else int(np.asarray(adam.count))),
        "mu": onto(adam.mu, ocfg.mu_dtype or torch.float32), "nu": onto(adam.nu),
        "acc": onto(multi.acc_grads) if ocfg.grad_accum > 1 else None,
    }


def train_state_from_jax(jax_state, trainer):
    """A JAX ``TrainState`` (numpy leaves, e.g. after ``jax.device_get``) ->
    the port's :class:`~mgldvsr_tpu_torch.train.trainer.TrainState` for
    ``trainer``: the merged parameters loaded into its pipeline's towers,
    float32 masters, EMA, Adam moments (the first in the trainer's mu dtype),
    the gradient accumulator and counts, and the step. Tests start both
    sides from one state, mid-accumulation included."""
    from mgldvsr_tpu_torch.train.trainer import TrainState, partition_params

    pipe = trainer.pipe
    dev = pipe.device
    frozen_np = jax_state.frozen
    merged = _merge_trees(frozen_np, jax_state.trainable)
    for tower, sd in pipeline_state_dicts(merged, pipe.cfg).items():
        pipe.towers()[tower].load_state_dict(sd, strict=True)

    def onto(tensors, dtype=torch.float32):
        return {k: v.to(device=dev, dtype=dtype) for k, v in tensors.items()}

    trainable = onto(_trainable_tensors(jax_state.trainable, frozen_np, pipe.cfg))
    opt = _opt_state(jax_state.opt_state, lambda t: _trainable_tensors(t, frozen_np, pipe.cfg),
                     trainer.opt_cfg, dev)
    ema = (onto(_trainable_tensors(jax_state.ema, frozen_np, pipe.cfg))
           if jax_state.ema is not None and trainer.cfg.use_ema else None)
    _, frozen = partition_params(pipe)
    state = TrainState(trainable=trainable, frozen=frozen, opt_state=opt, ema=ema,
                       step=int(np.asarray(jax_state.step)))
    trainer.load_towers(state)
    return state


def _vae_trainable_tensors(partial: Tree, frozen: Tree, cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    """A JAX tree over the stage-2 trainable VAE leaves only (params, a
    moment, an accumulator) -> port VAE names: completed with the frozen
    leaves, converted, cut back to the trainables."""
    from mgldvsr_tpu_torch.models.vae import is_temporal_or_fusion

    full = _merge_trees(_params(frozen), _params(partial))
    return {k: v for k, v in vae_state_dict(full, cfg).items() if is_temporal_or_fusion(k)}




def stage2_state_from_jax(jax_state, trainer):
    """A JAX ``Stage2State`` (numpy leaves) -> the port's
    :class:`~mgldvsr_tpu_torch.train.stage2.Stage2State` for ``trainer``:
    the VAE's parameters loaded into the trainer's VAE, float32 masters of
    its trainables and logvar, the discriminator's parameters and running
    statistics, LPIPS and SpyNet loaded into the trainer's modules, both
    Adam states with their accumulators and counts, and the step. Tests
    start both sides from one state."""
    from mgldvsr_tpu_torch.train.stage2 import Stage2State, partition_vae_params

    vae, dev = trainer.vae, trainer.device
    cfg = vae.cfg
    frozen_np = jax_state.gen_frozen
    vae.load_state_dict(vae_state_dict(_merge_trees(frozen_np, jax_state.gen_trainable), cfg),
                        strict=True)
    trainer.lpips.load_state_dict(lpips_state_dict(jax_state.aux["lpips"]), strict=True)
    trainer.spynet.load_state_dict(spynet_state_dict(jax_state.aux["spynet"]), strict=True)

    def gen_tensors(pair):
        tree, logvar = pair
        out = _vae_trainable_tensors(tree, frozen_np, cfg)
        out["logvar"] = _tensor(logvar).reshape(())
        return out

    disc_np = jax_state.disc

    def disc_tensors(tree):
        sd = discriminator_state_dict({"params": tree, "batch_stats": disc_np["batch_stats"]})
        return {k: v for k, v in sd.items() if "running" not in k}

    gen = {k: v.to(dev) for k, v in gen_tensors((jax_state.gen_trainable,
                                                  jax_state.logvar)).items()}
    logvar = gen.pop("logvar")
    disc = {k: v.to(dev) for k, v in discriminator_state_dict(disc_np).items()}
    _, frozen = partition_vae_params(vae)
    state = Stage2State(
        trainable=gen, frozen=frozen, logvar=logvar, disc=disc,
        opt_g=_opt_state(jax_state.opt_g, gen_tensors, trainer.opt_cfg, dev),
        opt_d=_opt_state(jax_state.opt_d, disc_tensors, trainer.opt_cfg, dev),
        step=int(np.asarray(jax_state.step)))
    trainer.load_vae(state)
    return state


# -- the BasicSR-heritage architectures and MaskFlownet ------------------------
# Each is the exact inverse of its ``mgldvsr_tpu/io/ckpt_convert.py``
# converter, in basicsr's key layout, and loads into the port's module of
# ``models/heritage`` (or ``flow/maskflownet``) with a plain
# ``load_state_dict``. ``unet_discriminator_sn_state_dict`` has no converter
# to invert and writes the port's keys, after the reference's modules.


def _frozen_bn_sd(g: _SD, key: str, p: Tree) -> None:
    g.raw(f"{key}.weight", p["scale"])
    g.raw(f"{key}.bias", p["bias"])
    g.raw(f"{key}.running_mean", p["mean"])
    g.raw(f"{key}.running_var", p["var"])


def _conv_res_blocks(g: _SD, p: Tree, num_block: int) -> None:
    g.conv("main.0", p["conv_in"])
    for i in range(num_block):
        g.conv(f"main.2.{i}.conv1", p[f"block_{i}"]["conv1"])
        g.conv(f"main.2.{i}.conv2", p[f"block_{i}"]["conv2"])


def _upsample_convs(g: _SD, p: Tree, upscale: int, name: str) -> None:
    idx, up = 0, upscale
    while up > 1:
        g.conv(f"upsample.{idx}", p[name.format(up)])
        idx += 2
        up //= 3 if up % 3 == 0 else 2


def deresnet_state_dict(tree: Tree, num_degradation: int = 2,
                        num_feats=(64, 128, 256, 512), num_blocks=(2, 2, 2, 2),
                        downscales=(2, 2, 2, 1)) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_deresnet`` (``conv_first.{d}``, ``body.{d}.{k}``,
    ``fc_degree.{d}.{0,2}``)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    n_stage = len(num_feats)
    for d in range(num_degradation):
        g.conv(f"conv_first.{d}", p[f"first_{d}"])
        seq = 0
        for stage in range(n_stage):
            for b in range(num_blocks[stage]):
                blk = g.scope(f"body.{d}.{seq}")
                blk.conv("conv1", p[f"body_{d}_{stage}_{b}"]["conv1"])
                blk.conv("conv2", p[f"body_{d}_{stage}_{b}"]["conv2"])
                seq += 1
            if downscales[stage] == 2 or (stage < n_stage - 1
                                          and num_feats[stage] != num_feats[stage + 1]):
                g.conv(f"body.{d}.{seq}", p[f"down_{d}_{stage}"])
                seq += 1
        g.linear(f"fc_degree.{d}.0", p[f"fc1_{d}"])
        g.linear(f"fc_degree.{d}.2", p[f"fc2_{d}"])
    return sd


def vgg_face_state_dict(tree: Tree, prefix: str = "vgg_extractor."
                        ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_vgg_face`` (``{prefix}vgg_net.convN_M``)."""
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd, f"{prefix}vgg_net.")
    for name, p in _params(tree).items():
        g.conv(name, p)
    return sd


def dfdnet_state_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_dfdnet`` (its spectral norm already folded)."""
    sd = vgg_face_state_dict(tree["vgg"])
    g = _SD(sd)
    for key, node in tree.items():
        if key not in ("vgg", "decoder"):
            g.conv(f"attn_blocks.{key}.0", node["params"]["conv1"])
            g.conv(f"attn_blocks.{key}.2", node["params"]["conv2"])
    dec = _params(tree["decoder"])
    ms = g.scope("multi_scale_dilation")
    ms.conv("conv_fusion", dec["msdilate"]["fusion"])
    for i in range(4):
        ms.conv(f"conv_blocks.{i}.0", dec["msdilate"][f"b{i}_conv1"])
        ms.conv(f"conv_blocks.{i}.2", dec["msdilate"][f"b{i}_conv2"])
    for i in range(4):
        u, up = g.scope(f"upsample{i}"), dec[f"up{i}"]
        for key, name in (("conv1.1", "conv1"), ("convup.1", "convup"),
                          ("scale_block.0", "scale1"), ("scale_block.2", "scale2"),
                          ("shift_block.0", "shift1"), ("shift_block.2", "shift2")):
            u.conv(key, up[name])
    u4 = g.scope("upsample4")
    u4.conv("0", dec["out_conv"])
    for idx, name in ((2, "out_res1"), (3, "out_res2")):
        u4.conv(f"{idx}.body.0", dec[name]["conv1"])
        u4.conv(f"{idx}.body.2", dec[name]["conv2"])
    u4.conv("4", dec["out_rgb"])
    return sd


def _hfg_spade_sd(g: _SD, p: Tree) -> None:
    g.conv("mlp_shared.0", p["mlp_shared"])
    g.conv("mlp_gamma", p["mlp_gamma"])
    g.conv("mlp_beta", p["mlp_beta"])


def _hfg_block_sd(g: _SD, p: Tree) -> None:
    g.conv("conv_0", p["conv_0"])
    g.conv("conv_1", p["conv_1"])
    _hfg_spade_sd(g.scope("norm_0"), p["norm_0"])
    _hfg_spade_sd(g.scope("norm_1"), p["norm_1"])
    if "conv_s" in p:
        g.conv("conv_s", p["conv_s"])
        _hfg_spade_sd(g.scope("norm_s"), p["norm_s"])


def hifacegan_state_dict(tree: Tree, n_2xdown: int = 5,
                         n_up_stages: int = 4) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_hifacegan`` (``lip_encoder.model.{k}``,
    ``head_0``, ``g_middle_{0,1}``, ``ups.{i}``, ``to_rgbs.{n-1}``)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    if "encoder" in p:
        enc = p["encoder"]
        g.conv("lip_encoder.model.0", enc["stem"])
        seq = 3
        for i in range(n_2xdown):
            lip = g.scope(f"lip_encoder.model.{seq}")
            lip.conv("logit.0", enc[f"lip_{i}"]["logit_conv"])
            lip.raw("logit.1.weight", enc[f"lip_{i}"]["in_scale"])
            lip.raw("logit.1.bias", enc[f"lip_{i}"]["in_bias"])
            g.conv(f"lip_encoder.model.{seq + 1}", enc[f"conv_{i}"])
            seq += 4 if i < n_2xdown - 1 else 3
    else:
        g.conv("fc", p["fc"])
    for name in ("head_0", "g_middle_0", "g_middle_1"):
        _hfg_block_sd(g.scope(name), p[name])
    for i in range(n_up_stages):
        _hfg_block_sd(g.scope(f"ups.{i}"), p[f"ups_{i}"])
    g.conv(f"to_rgbs.{n_up_stages - 1}", p[f"to_rgb_{n_up_stages - 1}"])
    return sd


def hifacegan_discriminator_state_dict(tree: Tree, num_d: int = 2,
                                       n_layers: int = 4) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_hifacegan_discriminator``."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    for i in range(num_d):
        d, dp = g.scope(f"discriminator_{i}"), p[f"d_{i}"]
        d.conv("model0.0", dp["conv0"])
        for n in range(1, n_layers):
            d.conv(f"model{n}.0.0", dp[f"conv{n}"])
        d.conv(f"model{n_layers}.0", dp["conv_out"])
    return sd


def rrdbnet_state_dict(tree: Tree, num_block: int = 23) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_rrdbnet``."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    for name in ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last"):
        g.conv(name, p[name])
    for i in range(num_block):
        for j in (1, 2, 3):
            for k in range(1, 6):
                g.conv(f"body.{i}.rdb{j}.conv{k}", p[f"body_{i}"][f"rdb{j}"][f"conv{k}"])
    return sd


def msrresnet_state_dict(tree: Tree, num_block: int = 16, upscale: int = 4
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_msrresnet``."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    names = ["conv_first", "upconv1", "conv_hr", "conv_last"] + (["upconv2"] if upscale == 4
                                                                  else [])
    for name in names:
        g.conv(name, p[name])
    for i in range(num_block):
        g.conv(f"body.{i}.conv1", p[f"body_{i}"]["conv1"])
        g.conv(f"body.{i}.conv2", p[f"body_{i}"]["conv2"])
    return sd


def srvgg_state_dict(tree: Tree, num_conv: int = 16) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_srvgg`` (the PReLU form)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    g.conv("body.0", p["conv_first"])
    g.raw("body.1.weight", p["act0_alpha"])
    for i in range(num_conv):
        g.conv(f"body.{2 * (i + 1)}", p[f"body_{i}"])
        g.raw(f"body.{2 * (i + 1) + 1}.weight", p[f"act{i + 1}_alpha"])
    g.conv(f"body.{2 * (num_conv + 1)}", p["conv_last"])
    return sd


def rcan_state_dict(tree: Tree, num_group: int = 10, num_block: int = 16,
                    upscale: int = 4) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_rcan``."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    for name in ("conv_first", "conv_after_body", "conv_last"):
        g.conv(name, p[name])
    for gi in range(num_group):
        grp = p[f"group_{gi}"]
        g.conv(f"body.{gi}.conv", grp["conv"])
        for bi in range(num_block):
            r, rp = g.scope(f"body.{gi}.residual_group.{bi}"), grp[f"rcab_{bi}"]
            r.conv("rcab.0", rp["conv1"])
            r.conv("rcab.2", rp["conv2"])
            r.conv("rcab.3.attention.1", rp["ca"]["down"])
            r.conv("rcab.3.attention.3", rp["ca"]["up"])
    _upsample_convs(g, p, upscale, "up_x{}")
    return sd


def basicvsr_state_dict(tree: Tree, num_block: int = 15) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_basicvsr`` (its SpyNet is ``spynet_state_dict``)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    _conv_res_blocks(g.scope("backward_trunk"), p["backward_trunk"], num_block)
    _conv_res_blocks(g.scope("forward_trunk"), p["forward_trunk"], num_block)
    for name in ("fusion", "upconv1", "upconv2", "conv_hr", "conv_last"):
        g.conv(name, p[name])
    return sd


_TSA_CONVS = ("temporal_attn1", "temporal_attn2", "feat_fusion", "spatial_attn1",
              "spatial_attn2", "spatial_attn3", "spatial_attn4", "spatial_attn5",
              "spatial_attn_l1", "spatial_attn_l2", "spatial_attn_l3", "spatial_attn_add1",
              "spatial_attn_add2")


def edvr_state_dict(tree: Tree, num_extract_block: int = 5, num_reconstruct_block: int = 10
                    ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_edvr`` (TSA, no pre-deblur)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    for name in ("conv_first", "conv_l2_1", "conv_l2_2", "conv_l3_1", "conv_l3_2", "upconv1",
                 "upconv2", "conv_hr", "conv_last"):
        g.conv(name, p[name])
    for i in range(num_extract_block):
        g.conv(f"feature_extraction.{i}.conv1", p[f"extract_{i}"]["conv1"])
        g.conv(f"feature_extraction.{i}.conv2", p[f"extract_{i}"]["conv2"])
    for i in range(num_reconstruct_block):
        g.conv(f"reconstruction.{i}.conv1", p[f"recon_{i}"]["conv1"])
        g.conv(f"reconstruction.{i}.conv2", p[f"recon_{i}"]["conv2"])
    a, pcd = g.scope("pcd_align"), p["pcd"]
    for lvl in (3, 2, 1):
        names = ["offset_conv1", "offset_conv2"] + (["offset_conv3", "feat_conv"] if lvl < 3
                                                    else [])
        for name in names:
            a.conv(f"{name}.l{lvl}", pcd[f"{name}_l{lvl}"])
        a.conv(f"dcn_pack.l{lvl}.conv_offset", pcd[f"dcn_offset_l{lvl}"])
        a.raw(f"dcn_pack.l{lvl}.weight", pcd[f"dcn_weight_l{lvl}"], _conv_layout)
        a.raw(f"dcn_pack.l{lvl}.bias", pcd[f"dcn_bias_l{lvl}"])
    a.conv("cas_offset_conv1", pcd["cas_offset_conv1"])
    a.conv("cas_offset_conv2", pcd["cas_offset_conv2"])
    a.conv("cas_dcnpack.conv_offset", pcd["cas_dcn_offset"])
    a.raw("cas_dcnpack.weight", pcd["cas_dcn_weight"], _conv_layout)
    a.raw("cas_dcnpack.bias", pcd["cas_dcn_bias"])
    for name in _TSA_CONVS:
        g.conv(f"fusion.{name}", p["fusion"][name])
    return sd


def swinir_state_dict(tree: Tree, depths=(2, 2), upscale: int = 4) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_swinir`` (the relative position index and the
    shift masks are not stored)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    g.conv("conv_first", p["conv_first"])
    g.norm("patch_embed.norm", p["norm_embed"])
    g.norm("norm", p["norm_body"])
    g.conv("conv_after_body", p["conv_after_body"])
    g.conv("conv_before_upsample.0", p["conv_before_upsample"])
    g.conv("conv_last", p["conv_last"])
    for li, depth in enumerate(depths):
        lay = p[f"layer_{li}"]
        g.conv(f"layers.{li}.conv", lay["conv"])
        for bi in range(depth):
            b, bp = g.scope(f"layers.{li}.residual_group.blocks.{bi}"), lay[f"block_{bi}"]
            b.norm("norm1", bp["norm1"])
            b.norm("norm2", bp["norm2"])
            b.linear("attn.qkv", bp["attn"]["qkv"])
            b.linear("attn.proj", bp["attn"]["proj"])
            b.raw("attn.relative_position_bias_table", bp["attn"]["relative_position_bias_table"])
            b.linear("mlp.fc1", bp["mlp_fc1"])
            b.linear("mlp.fc2", bp["mlp_fc2"])
    _upsample_convs(g, p, upscale, "upsample_conv_x{}")
    return sd


def basicvsrpp_state_dict(tree: Tree, num_block: int = 7) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_basicvsrpp`` (its SpyNet is ``spynet_state_dict``)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    _conv_res_blocks(g.scope("feat_extract"), p["feat_extract"], 5)
    _conv_res_blocks(g.scope("reconstruction"), p["reconstruction"], 5)
    for name in ("upconv1", "upconv2", "conv_hr", "conv_last"):
        g.conv(name, p[name])
    for name in ("backward_1", "forward_1", "backward_2", "forward_2"):
        d, dp = g.scope(f"deform_align.{name}"), p[f"deform_align_{name}"]
        for i in range(4):
            d.conv(f"conv_offset.{2 * i}", dp[f"offset_conv{i + 1}"])
        d.raw("weight", dp["dcn_weight"], _conv_layout)
        d.raw("bias", dp["dcn_bias"])
        _conv_res_blocks(g.scope(f"backbone.{name}"), p[f"backbone_{name}"], num_block)
    return sd


def toflow_state_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_toflow`` (the batch norms without
    ``num_batches_tracked``)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    for i in (1, 2, 3, 4):
        g.conv(f"conv_{i}", p[f"conv_{i}"])
    for i in range(4):
        b, mp = g.scope(f"spynet.basic_module.{i}.basic_module"), p["spynet"][f"basic_module_{i}"]
        for k in range(4):
            b.conv(str(3 * k), mp[f"conv{k}"])
            _frozen_bn_sd(b, str(3 * k + 1), mp[f"bn{k}"])
        b.conv("12", mp["conv4"])
    return sd


def duf_state_dict(tree: Tree, num_layer: int = 52) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_duf``."""
    num_block = {16: 3, 28: 9, 52: 21}[num_layer]
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)

    def unit(b: _SD, up: Tree) -> None:
        _frozen_bn_sd(b, "0", up["bn0"])
        b.conv("2", up["conv0"])
        _frozen_bn_sd(b, "3", up["bn1"])
        b.conv("5", up["conv1"])

    for name in ("conv3d1", "conv3d2", "conv3d_r1", "conv3d_r2", "conv3d_f1", "conv3d_f2"):
        g.conv(name, p[name])
    _frozen_bn_sd(g, "bn3d2", p["bn3d2"])
    for i in range(num_block):
        unit(g.scope(f"dense_block1.dense_blocks.{i}"), p[f"dense_{i}"])
    for i in range(3):
        unit(g.scope(f"dense_block2.temporal_reduce{i + 1}"), p[f"reduce_{i}"])
    return sd


def ridnet_state_dict(tree: Tree, num_block: int = 4, img_range: float = 255.0,
                      rgb_mean=(0.4488, 0.4371, 0.4040), rgb_std=(1.0, 1.0, 1.0)
                      ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_ridnet``; ``sub_mean`` / ``add_mean`` hold the
    reference's MeanShift constants (the converter only consumes them)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    std = np.asarray(rgb_std, np.float32)
    mean = np.asarray(rgb_mean, np.float32)
    for name, sign in (("sub_mean", -1), ("add_mean", 1)):
        g.raw(f"{name}.weight", np.eye(3, dtype=np.float32).reshape(3, 3, 1, 1)
              / std.reshape(3, 1, 1, 1))
        g.raw(f"{name}.bias", sign * img_range * mean / std)
    g.conv("head", p["head"])
    g.conv("tail", p["tail"])
    for i in range(num_block):
        b, e = g.scope(f"body.{i}"), p[f"eam_{i}"]
        for key, name in (("merge.dilation1.0", "mr_d1_conv1"),
                          ("merge.dilation1.2", "mr_d1_conv2"),
                          ("merge.dilation2.0", "mr_d2_conv1"),
                          ("merge.dilation2.2", "mr_d2_conv2"),
                          ("merge.aggregation.0", "mr_agg"), ("block2.body.0", "er_conv1"),
                          ("block2.body.2", "er_conv2"), ("block2.body.4", "er_conv3"),
                          ("ca.attention.1", "ca_down"), ("ca.attention.3", "ca_up")):
            b.conv(key, e[name])
        b.conv("block1.conv1", e["block1"]["conv1"])
        b.conv("block1.conv2", e["block1"]["conv2"])
    return sd


def ecbsr_state_dict(tree: Tree, num_block: int = 4, with_idt: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_ecbsr``: each folded 3x3 conv becomes the
    training form's ``conv3x3`` with every other branch zero (and the fixed
    edge masks), which the converter folds back to it bit for bit (with
    ``with_idt`` the identity is taken off first, which can round)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    names = ["ecb_in"] + [f"ecb_{i}" for i in range(num_block)] + ["conv_out"]
    for idx, name in enumerate(names):
        node = p[name]
        rep = node["conv"] if "conv" in node else node
        w = np.asarray(rep["kernel"]).transpose(3, 2, 0, 1).astype(np.float32)
        cout, cin = w.shape[:2]
        if with_idt and cout == cin:
            w = w.copy()
            w[np.arange(cout), np.arange(cout), 1, 1] -= 1.0
        b = g.scope(f"backbone.{idx}")
        b.raw("conv3x3.weight", w)
        b.raw("conv3x3.bias", rep["bias"])
        mid = ECB_DEPTH_MULTIPLIER * cout
        zeros = lambda *s: np.zeros(s, np.float32)  # noqa: E731
        b.raw("conv1x1_3x3.k0", zeros(mid, cin, 1, 1))
        b.raw("conv1x1_3x3.b0", zeros(mid))
        b.raw("conv1x1_3x3.k1", zeros(cout, mid, 3, 3))
        b.raw("conv1x1_3x3.b1", zeros(cout))
        for kind in EDGE_KINDS:
            e = b.scope(f"conv1x1_{kind}")
            e.raw("k0", zeros(cout, cin, 1, 1))
            e.raw("b0", zeros(cout))
            e.raw("scale", zeros(cout, 1, 1, 1))
            e.raw("bias", zeros(cout))
            e.raw("mask", edge_mask(kind, cout).numpy())
        if "prelu_alpha" in node:
            b.raw("act.weight", node["prelu_alpha"])
    return sd


def _sg2_modconv_sd(g: _SD, p: Tree) -> None:
    g.raw("weight", p["weight"], lambda k: _conv_layout(k)[None])
    g.raw("modulation.weight", p["modulation"]["weight"], np.transpose)
    g.raw("modulation.bias", p["modulation"]["bias"])


def _sg2_styleconv_sd(g: _SD, p: Tree) -> None:
    _sg2_modconv_sd(g.scope("modulated_conv"), p["modulated_conv"])
    g.raw("weight", p["noise_weight"], lambda a: a.reshape(1))
    g.raw("activate.bias", p["bias"])


def _sg2_torgb_sd(g: _SD, p: Tree) -> None:
    _sg2_modconv_sd(g.scope("modulated_conv"), p["modulated_conv"])
    g.raw("bias", p["bias"], lambda a: a.reshape(1, 3, 1, 1))


def stylegan2_state_dict(tree: Tree, out_size: int = 64, num_mlp: int = 8
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_stylegan2``: ``{"params", "_noises"}`` (the
    noise maps NHWC) -> basicsr's generator keys with ``noises.noise{i}``."""
    import math

    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    g.raw("constant_input.weight", p["constant_input"], lambda a: a.transpose(0, 3, 1, 2))
    _sg2_styleconv_sd(g.scope("style_conv1"), p["style_conv1"])
    _sg2_torgb_sd(g.scope("to_rgb1"), p["to_rgb1"])
    for i in range(num_mlp):
        g.raw(f"style_mlp.{i + 1}.weight", p[f"mlp_{i}"]["weight"], np.transpose)
        g.raw(f"style_mlp.{i + 1}.bias", p[f"mlp_{i}"]["bias"])
    log_size = int(math.log2(out_size))
    for j in range(2 * (log_size - 2)):
        _sg2_styleconv_sd(g.scope(f"style_convs.{j}"), p[f"style_convs_{j}"])
    for i in range(log_size - 2):
        _sg2_torgb_sd(g.scope(f"to_rgbs.{i}"), p[f"to_rgbs_{i}"])
    for i, noise in enumerate(tree["_noises"]):
        g.raw(f"noises.noise{i}", noise, lambda a: a.transpose(0, 3, 1, 2))
    return sd


def stylegan2_discriminator_state_dict(tree: Tree, in_size: int = 64
                                       ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_stylegan2_discriminator``."""
    import math

    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)

    def convlayer(s: _SD, lp: Tree, conv_idx: int) -> None:
        s.raw(f"{conv_idx}.weight", lp["conv"]["weight"], _conv_layout)
        if "bias" in lp:
            s.raw(f"{conv_idx + 1}.bias", lp["bias"])

    convlayer(g.scope("conv_body.0"), p["conv_body_0"], 0)
    for li in range(1, int(math.log2(in_size)) - 1):
        b, bp = g.scope(f"conv_body.{li}"), p[f"conv_body_{li}"]
        convlayer(b.scope("conv1"), bp["conv1"], 0)
        convlayer(b.scope("conv2"), bp["conv2"], 1)
        convlayer(b.scope("skip"), bp["skip"], 1)
    convlayer(g.scope("final_conv"), p["final_conv"], 0)
    for i in (0, 1):
        g.raw(f"final_linear.{i}.weight", p[f"final_linear_{i}"]["weight"], np.transpose)
        g.raw(f"final_linear.{i}.bias", p[f"final_linear_{i}"]["bias"])
    return sd


def coupleprop_state_dict(tree: Tree, num_block: int = 5) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_coupleprop``."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    _conv_res_blocks(g.scope("backward_trunk"), p["backward_trunk"], num_block)
    _conv_res_blocks(g.scope("forward_trunk"), p["forward_trunk"], num_block)
    for name in ("backward_fusion", "forward_fusion", "conv_last"):
        g.conv(name, p[name])
    return sd


def _deconv_layout(k: np.ndarray) -> np.ndarray:
    """flax ConvTranspose [kh, kw, in, out] (spatially flipped) -> torch
    ConvTranspose2d [in, out, kh, kw]: the inverse of ``deconv_kernel``."""
    return k[::-1, ::-1].transpose(2, 3, 0, 1)


def maskflownet_state_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_maskflownet``."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    for i in range(1, 7):
        for s in "abc":
            g.conv(f"conv{i}{s}.0", p[f"enc{i - 1}{s}"]["conv"])

    def head(ref: str, name: str) -> None:
        for j in range(5):
            g.conv(f"{ref}_{j}.0", p[name][f"conv_{j}"]["conv"])

    head("conv6", "head6")
    g.conv("pred_flow6", p["pred_flow6"])
    g.conv("pred_mask6", p["pred_mask6"])
    for k in (5, 4, 3, 2):
        o = k - 1
        g.raw(f"upfeat{k}.weight", p[f"upfeat{o}"]["deconv"]["kernel"], _deconv_layout)
        g.raw(f"upfeat{k}.bias", p[f"upfeat{o}"]["deconv"]["bias"])
        g.raw(f"deform{k}.weight", p[f"deform{o}"]["weight"], _conv_layout)
        g.raw(f"deform{k}.bias", p[f"deform{o}"]["bias"])
        g.conv(f"conv{k}f.0", p[f"convf{o}"])
        head(f"conv{k}", f"head{o}")
        g.conv(f"pred_flow{k}", p[f"pred_flow{o}"])
        if k != 2:
            g.conv(f"pred_mask{k}", p[f"pred_mask{o}"])
    for i in range(1, 7):
        g.conv(f"dc_conv{i}.0", p[f"dc{i - 1}"]["conv"])
    g.conv("dc_conv7", p["dc_flow"])
    return sd


def unet_discriminator_sn_state_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    """Real-ESRGAN's U-Net discriminator from the JAX module's
    ``{"params", "spectral"}``: ``conv0`` / ``conv9`` plain, ``conv1``-``8``
    as torch's spectral-norm triple (``weight_orig``, ``bias``, ``weight_u``
    = the JAX ``u``, ``weight_v`` the power step's ``v`` in torch's
    flattening; the port's forward recomputes ``v`` and does not read it)."""
    p, spec = tree["params"], tree["spectral"]
    sd: Dict[str, torch.Tensor] = {}
    g = _SD(sd)
    g.conv("conv0", p["conv0"])
    g.conv("conv9", p["conv9"])
    for i in range(1, 9):
        k = np.asarray(p[f"conv{i}"]["kernel"], np.float32)
        u = np.asarray(spec[f"conv{i}"]["u"], np.float32)
        v = k.reshape(-1, k.shape[-1]) @ u
        v = (v / (np.linalg.norm(v) + 1e-12)).reshape(k.shape[:3]).transpose(2, 0, 1)
        g.raw(f"conv{i}.weight_orig", k, _conv_layout)
        g.raw(f"conv{i}.bias", p[f"conv{i}"]["bias"])
        g.raw(f"conv{i}.weight_u", u)
        g.raw(f"conv{i}.weight_v", v.reshape(-1))
    return sd

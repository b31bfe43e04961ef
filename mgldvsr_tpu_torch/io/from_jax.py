"""JAX parameter trees -> port state dicts.

One function per tower, each the exact inverse of the JAX package's
converter of that tower (``mgldvsr_tpu/io/ckpt_convert.py``):
``convert_unet``, ``convert_structcond``, ``convert_autoencoder(video=True,
fusion=True)``, ``convert_openclip_text`` and ``convert_raft``, of the
stage-2 loss networks ``convert_lpips``, ``convert_discriminator`` and
``convert_spynet``, and of FID's ``convert_inception``. The input is
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
        b, bp = g.scope(f"transformer.resblocks.{i}"), p[f"resblock_{i}"]
        b.norm("ln_1", bp["ln_1"])
        b.norm("ln_2", bp["ln_2"])
        b.raw("attn.in_proj_weight", bp["attn_in_proj"]["kernel"], np.transpose, out_axis=0)
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

"""The shipped SD2.1 geometry's state dicts, without their 1.45 G values:
the JAX pipeline's parameter shapes (``jax.eval_shape`` of its init), each
leaf a cheap array that names itself, through ``io.from_jax`` into the
port's modules built on torch's ``meta`` device, and back through the JAX
converters (``ckpt_convert.convert_unet`` / ``convert_structcond`` /
``convert_autoencoder`` / ``convert_openclip_text`` / ``convert_raft``).

The tiny-width round trip (``tests/test_torch_models.py``) never builds
four UNet levels (``input_blocks.0-11``, ``output_blocks.0-11``,
``middle_block.0-5``), the 24-layer text tower, or the VAE at two res
blocks a level: this checks the layout a real checkpoint loads through.

Leaves up to 65,536 elements hold distinct values; larger ones are a ramp
along their last axis broadcast over the others (no memory), offset by the
leaf's index (modulo 200), so a leaf sent to another key or a transposed
kernel shows.

The tensor-parallel rule at the same geometry: the port reads each leaf's
JAX path from ``io.from_jax``'s maps (``jax_paths``) and must split exactly
the leaves the JAX package's ``_param_spec`` splits in this tree.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mgldvsr_tpu.infer.pipeline import MGLDVSRPipeline as JaxPipeline
from mgldvsr_tpu.infer.pipeline import PipelineConfig as JaxPipelineConfig
from mgldvsr_tpu.io import ckpt_convert
from mgldvsr_tpu.parallel import mesh as jmesh
from mgldvsr_tpu_torch.flow.raft import RAFT
from mgldvsr_tpu_torch.io import from_jax
from mgldvsr_tpu_torch.models.cliptext import OpenCLIPTextEncoder
from mgldvsr_tpu_torch.models.unet import InflatedUNetDualCond, StructCondEncoder
from mgldvsr_tpu_torch.models.vae import VideoAutoencoderKLResi
from mgldvsr_tpu_torch.parallel import mesh, tensor
from tests.test_torch_models import port_config

SMALL = 1 << 16


def _leaf(i: int, shape) -> np.ndarray:
    """Whole numbers under 2^24, exact in float32."""
    size = int(np.prod(shape))
    offset = (i % 200) * SMALL
    if size <= SMALL:
        return (np.arange(size, dtype=np.float32) + offset).reshape(shape)
    return np.broadcast_to(np.arange(shape[-1], dtype=np.float32) + offset, shape)


def _tensor_view(a) -> torch.Tensor:
    """from_jax's leaf -> tensor without the copy (a broadcast leaf stays
    a zero-stride view)."""
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


@pytest.fixture(scope="module")
def shipped():
    jcfg = JaxPipelineConfig()
    assert (jcfg.unet.model_channels, jcfg.clip.layers, jcfg.vae.ch, jcfg.raft.iters) == (
        320, 24, 128, 10)
    pipe = JaxPipeline(jcfg)
    shapes = jax.eval_shape(lambda: pipe._init_params_exact(jax.random.PRNGKey(0), 64, 64))
    flat, treedef = jax.tree_util.tree_flatten(shapes)
    tree = jax.tree_util.tree_unflatten(treedef, [_leaf(i, s.shape) for i, s in enumerate(flat)])
    return jcfg, port_config(jcfg), tree


def _converter(tower, jcfg):
    u, s, v = jcfg.unet, jcfg.structcond, jcfg.vae
    return {
        "unet": lambda d, **k: ckpt_convert.convert_unet(
            d, prefix="", channel_mult=u.channel_mult, num_res_blocks=u.num_res_blocks,
            attention_resolutions=u.attention_resolutions,
            transformer_depth=u.transformer_depth, **k),
        "structcond": lambda d, **k: ckpt_convert.convert_structcond(
            d, prefix="", channel_mult=s.channel_mult, model_channels=s.model_channels,
            num_res_blocks=s.num_res_blocks, attention_resolutions=s.attention_resolutions,
            num_heads=s.num_heads, **k),
        "vae": lambda d, **k: ckpt_convert.convert_autoencoder(
            d, prefix="", video=True, fusion=True, ch_mult=v.ch_mult,
            num_res_blocks=v.num_res_blocks, attn_resolutions=v.attn_resolutions,
            resolution=v.resolution, **k),
        "clip": lambda d, **k: ckpt_convert.convert_openclip_text(
            d, prefix="", layers=jcfg.clip.layers,
            penultimate=jcfg.clip.layer == "penultimate", **k),
        "raft": lambda d, **k: ckpt_convert.convert_raft(d, prefix="", **k),
    }[tower]


def _module(tower, cfg):
    with torch.device("meta"):
        return {"unet": lambda: InflatedUNetDualCond(cfg.unet),
                "structcond": lambda: StructCondEncoder(cfg.structcond),
                "vae": lambda: VideoAutoencoderKLResi(cfg.vae),
                "clip": lambda: OpenCLIPTextEncoder(cfg.clip),
                "raft": lambda: RAFT(cfg.raft)}[tower]()


EXPECTED_KEYS = {  # what the shipped geometry must hold
    "unet": ("input_blocks.11.0.spade.mlp_gamma.weight", "output_blocks.11.1.proj_out.weight",
             "middle_block.5.temporal_alpha", "middle_block.3.temporal_attn.to_q.weight"),
    "structcond": ("input_blocks.8.1.qkv.weight", "input_blocks.7.0.skip_connection.weight",
                   "input_blocks.11.0.out_layers.3.weight", "fea_tran.3.out_layers.3.weight"),
    "vae": ("encoder.down.3.block.1.conv2.weight", "decoder.up.3.block.2.conv2.weight",
            "decoder.fusion_layer_2.encode_enc_2.1.conv5.weight",
            "decoder.up.0.temporal_mixing.2.temporal_alpha"),
    "clip": ("transformer.resblocks.22.mlp.c_proj.weight",),
    "raft": ("update_block.flow_head.conv2.weight",),
}


@pytest.mark.parametrize("tower", ["unet", "structcond", "vae", "clip", "raft"])
def test_shipped_layout_round_trips_and_loads_strictly(shipped, tower, monkeypatch):
    jcfg, cfg, tree = shipped
    monkeypatch.setattr(from_jax, "_tensor", _tensor_view)
    sd = {"unet": from_jax.unet_state_dict, "structcond": from_jax.structcond_state_dict,
          "vae": from_jax.vae_state_dict, "clip": from_jax.clip_state_dict,
          "raft": from_jax.raft_state_dict}[tower](tree[tower], getattr(cfg, tower))
    for key in EXPECTED_KEYS[tower]:
        assert key in sd, key
    if tower == "clip":
        assert "transformer.resblocks.23.ln_1.weight" not in sd  # penultimate: 23 blocks

    module = _module(tower, cfg)
    want_shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want_shapes
    module.load_state_dict(sd, strict=True, assign=True)

    used: set = set()
    back = _converter(tower, jcfg)(sd, used=used)
    assert used == set(sd), sorted(set(sd) - used)[:5]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(tree[tower])[0])
    assert flat_back.keys() == flat_want.keys()
    for path, want in flat_want.items():
        got = np.asarray(flat_back[path])
        assert got.shape == want.shape and np.array_equal(got, want), path


def test_shipped_geometry_sizes(shipped):
    """The parameter counts of the five towers at the shipped widths."""
    _, cfg, tree = shipped
    counts = {name: sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(sub))
              for name, sub in tree.items()}
    assert counts == {"unet": 935321287, "structcond": 52494080, "vae": 114973812,
                      "clip": 340387840, "raft": 5260416}
    for name in counts:
        module = _module(name, cfg)
        assert sum(p.numel() for p in module.state_dict().values()) == counts[name], name
    assert dataclasses.replace(cfg.unet).use_temporal and cfg.unet.use_spade


TOWERS = ["unet", "structcond", "vae", "clip", "raft"]


@pytest.mark.parametrize("tower", TOWERS)
def test_shipped_tensor_rule_splits_what_jax_splits(shipped, tower):
    """Each torch key's JAX path (``from_jax.jax_paths``) is a leaf of the
    shipped JAX tree with as many elements, whose last axis is as wide as
    the torch axis named for it, and every JAX leaf is one key's. At T = 2
    and 4 the port's rule (``mesh.tensor_axes``) splits exactly the leaves
    for which ``_param_spec`` returns a ``tensor`` axis, along that torch
    axis; ``time_embed``'s kernels are split (no ``embedding`` in their
    flax path), CLIP's token and positional embeddings are not."""
    jcfg, cfg, tree = shipped
    module = _module(tower, cfg)
    sd = module.state_dict()
    by_path = {path[1:]: (k, axis) for k, (path, axis) in from_jax.jax_paths(tower, module).items()}
    flat = jax.tree_util.tree_flatten_with_path(tree[tower])[0]

    def keys(path):
        names = tuple(e.key for e in path)
        return names[1:] if names[0] == "params" else names

    assert set(by_path) == {keys(path) for path, _ in flat}
    for path, leaf in flat:
        k, axis = by_path[keys(path)]
        assert leaf.size == sd[k].numel(), k
        if leaf.ndim >= 2:
            assert leaf.shape[-1] == sd[k].shape[axis], k
    for tp in (2, 4):
        want = {}
        for path, leaf in flat:
            if "tensor" in tuple(jmesh._param_spec(tuple(str(e) for e in path), leaf, tp)):
                k, axis = by_path[keys(path)]
                want[k] = axis % sd[k].ndim
        got = mesh.tensor_axes(tower, module, tp)
        assert got == want, (tp, sorted(set(got) ^ set(want))[:5])
        assert want and set(want.values()) == {0}
        if tower in ("unet", "structcond"):
            assert "time_embed.0.weight" in got
        if tower == "clip":
            assert "token_embedding.weight" not in got and "positional_embedding" not in got
            assert "transformer.resblocks.0.attn.in_proj_weight" in got


def test_shipped_split_holds_each_rank_s_share(shipped):
    """A rank of a T-rank tensor group holds its rows of every split leaf:
    after ``shard_module`` (on ``meta``, as rank 1 of T), every tower's
    parameter count, trainable and frozen alike, falls by the split leaves'
    elements x (1 - 1/T) at T = 2 and 4; the split leaves are most of every
    tower but RAFT's."""
    _, cfg, _ = shipped
    for tp in (2, 4):
        grid = mesh.Grid(dp=1, tp=tp, data_index=0, tensor_index=1)
        for tower in TOWERS:
            module = _module(tower, cfg)
            axes = mesh.tensor_axes(tower, module, tp)
            whole = sum(p.numel() for p in module.parameters())
            split = sum(p.numel() for n, p in module.named_parameters() if n in axes)
            tensor.shard_module(module, axes, grid)
            held = sum(p.numel() for p in module.parameters())
            assert held == whole - split * (tp - 1) // tp, (tower, tp)
            assert split / whole > (0.5 if tower != "raft" else 0.1), (tower, split / whole)
            assert sorted(tensor.split_parameters(module)) == sorted(axes)

"""The towers' remaining config options against the JAX package at tiny
widths, float32 on the CPU: the UNet's ``use_temporal``, ``use_spade`` and
``use_linear_in_transformer``, ``dropout`` in the UNet, struct-cond encoder
and VAE, the image ``AutoencoderKL``, ``MultiDimTemporalConv``, the ViT-L
text tower (``frozen_clip_vit_l_config``, Hugging Face key names), the two
TPU-only options the port refuses, and the options through the CLIs.

Each variant's weights go JAX init -> io.from_jax -> port, and each
from_jax state dict goes back through the JAX converter bit for bit.
Tolerances are those of ``tests/test_torch_models.py`` for the same
towers (1e-4; 2e-4 for a restore and a decode): a few times the largest
difference observed, far below the activations' scale.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.flow.raft import RAFTConfig as JaxRAFTConfig
from mgldvsr_tpu.infer.pipeline import MGLDVSRPipeline as JaxPipeline
from mgldvsr_tpu.infer.pipeline import PipelineConfig as JaxPipelineConfig
from mgldvsr_tpu.infer.pipeline import _synthesize_leaves
from mgldvsr_tpu.io import ckpt_convert
from mgldvsr_tpu.models import cliptext as jclip
from mgldvsr_tpu.models import temporal as jtemporal
from mgldvsr_tpu.models import unet as junet
from mgldvsr_tpu.models import vae as jvae
from mgldvsr_tpu_torch.cli import infer as infer_cli
from mgldvsr_tpu_torch.cli import train as train_cli
from mgldvsr_tpu_torch.flow.raft import RAFTConfig
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, PipelineConfig
from mgldvsr_tpu_torch.io import from_jax, torch_ckpt
from mgldvsr_tpu_torch.models import layers
from mgldvsr_tpu_torch.models.cliptext import (
    CLIPTextConfig,
    OpenCLIPTextEncoder,
    empty_prompt_tokens,
    frozen_clip_vit_l_config,
)
from mgldvsr_tpu_torch.models.temporal import MultiDimTemporalConv
from mgldvsr_tpu_torch.models.unet import (
    InflatedUNetDualCond,
    StructCondConfig,
    StructCondEncoder,
    UNetConfig,
)
from mgldvsr_tpu_torch.models.vae import AutoencoderKL, VAEConfig, VideoAutoencoderKLResi
from mgldvsr_tpu_torch.utils import config as pconfig
from tests.test_pipeline import tiny_config
from tests.test_torch_cli import _write_clip
from tests.test_torch_models import nchw, numpy_tree, port_config, t2n, to_nhwc
from tests.test_torch_pipeline import _frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def sub(cls, jcfg, **over):
    """The port dataclass ``cls`` with every field of the JAX ``jcfg`` it
    shares (dtype left at float32)."""
    names = {f.name for f in dataclasses.fields(cls)} - {"dtype"}
    return cls(**{n: getattr(jcfg, n) for n in names}, **over)


def jax_params(module, *args, seed=0, **kwargs):
    """Seeded params of a flax module from its shapes (no init compile),
    every leaf moved by N(0, 0.05) so zero biases and blend scalars take
    part too."""
    key = jax.random.PRNGKey(seed)
    shapes = jax.eval_shape(lambda: module.init(key, *args, **kwargs))
    tree = numpy_tree(_synthesize_leaves(shapes, key))
    rs = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), tree)


def assert_round_trip(tree, sd, convert):
    """from_jax's state dict -> the JAX converter gives ``tree`` back bit
    for bit and reads every key."""
    used: set = set()
    back = convert({k: v.numpy() for k, v in sd.items()}, used=used)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert flat_back.keys() == flat_want.keys()
    for path, want in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(want),
                                      err_msg=str(path))
    assert used == set(sd), sorted(set(sd) - used)


# -- the UNet's layouts --------------------------------------------------------

UNET_VARIANTS = {
    "image_sr": dict(use_temporal=False),                      # UNetModelDualcondV2
    "stock_resblocks": dict(use_spade=False),
    "stock_unet": dict(use_temporal=False, use_spade=False),   # UNetModel
    "conv_projections": dict(use_linear_in_transformer=False),
}


def _unet_inputs(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(5, 8, 8, 4).astype(np.float32)
    t = np.array([999, 500, 10, 0, 250], np.int32)
    ctx = rs.randn(5, 77, 32).astype(np.float32)
    s_cond = {"8": rs.randn(5, 8, 8, 32).astype(np.float32),
              "4": rs.randn(5, 4, 4, 32).astype(np.float32)}
    return x, t, ctx, s_cond


@functools.lru_cache(maxsize=None)
def _unet(variant: str, dropout: float = 0.0):
    jcfg = dataclasses.replace(tiny_config().unet, dropout=dropout, **UNET_VARIANTS.get(variant, {}))
    net = junet.InflatedUNetDualCond(jcfg)
    x, t, ctx, s_cond = _unet_inputs()
    tree = jax_params(net, x, t, ctx, s_cond)
    cfg = sub(UNetConfig, jcfg)
    return jcfg, net, tree, cfg, from_jax.unet_state_dict(tree, cfg)


def _convert_unet(jcfg):
    return lambda d, **k: ckpt_convert.convert_unet(
        d, prefix="", channel_mult=jcfg.channel_mult, num_res_blocks=jcfg.num_res_blocks,
        attention_resolutions=jcfg.attention_resolutions,
        transformer_depth=jcfg.transformer_depth, dual=jcfg.use_spade,
        temporal=jcfg.use_temporal, **k)


def _port_unet(cfg, sd):
    net = InflatedUNetDualCond(cfg)
    net.load_state_dict(sd, strict=True)
    return net


@pytest.mark.parametrize("variant", sorted(UNET_VARIANTS))
def test_unet_variant_matches_jax(variant):
    jcfg, net, tree, cfg, sd = _unet(variant)
    x, t, ctx, s_cond = _unet_inputs(1)
    want = jax.jit(net.apply)(tree, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                              {k: jnp.asarray(v) for k, v in s_cond.items()})
    with torch.no_grad():
        got = _port_unet(cfg, sd)(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx),
                                  {k: nchw(v) for k, v in s_cond.items()})
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert np.abs(np.asarray(want)).max() > 1e-2


@pytest.mark.parametrize("variant", sorted(UNET_VARIANTS))
def test_unet_variant_round_trip_is_exact(variant):
    """The layouts' keys: no temporal modules and a res / transformer / res
    middle block without ``use_temporal``, no ``spade`` without
    ``use_spade``, [inner, c, 1, 1] projections without linear ones."""
    jcfg, _, tree, cfg, sd = _unet(variant)
    assert_round_trip(tree, sd, _convert_unet(jcfg))
    keys = set(sd)
    assert any("temporal" in k for k in keys) == jcfg.use_temporal
    assert any(".spade." in k for k in keys) == jcfg.use_spade
    assert ("middle_block.5.temporal_alpha" in keys) == jcfg.use_temporal
    proj = sd["input_blocks.1.1.proj_in.weight"]
    assert proj.ndim == (2 if jcfg.use_linear_in_transformer else 4)
    assert set(_port_unet(cfg, sd).state_dict()) == keys


def test_stock_unet_ignores_struct_cond():
    """Without SPADE the features are not read: None gives the same eps."""
    _, _, _, cfg, sd = _unet("stock_unet")
    x, t, ctx, s_cond = _unet_inputs(2)
    net = _port_unet(cfg, sd)
    with torch.no_grad():
        a = net(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx),
                {k: nchw(v) for k, v in s_cond.items()})
        b = net(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx), None)
    assert torch.equal(a, b)


def test_image_sr_restore_matches_jax():
    """The tiny deterministic restore with the stock UNet
    (use_temporal=False, use_spade=False), port against JAX: the pipelines
    still run the struct-cond encoder, as the JAX one does, and the UNet
    does not read it."""
    base = tiny_config(num_frames=5, ddpm_steps=2)
    jcfg = dataclasses.replace(base, unet=dataclasses.replace(
        base.unet, use_temporal=False, use_spade=False))
    jpipe = JaxPipeline(jcfg)
    params = numpy_tree(jpipe.init_params(jax.random.PRNGKey(0), 32, 32))
    params["raft"]["params"]["update_scan"]["update_block"]["flow_head_conv2"]["kernel"] *= 1e-2
    cfg = port_config(jcfg)
    pipe = MGLDVSRPipeline(cfg, device="cpu")
    for name, sd in from_jax.pipeline_state_dicts(params, cfg).items():
        pipe.towers()[name].load_state_dict(sd, strict=True)
    frames = _frames(0, size=32)
    want = jax.jit(lambda p, f: jpipe.restore_segment(
        p, f, jax.random.PRNGKey(0), deterministic=True))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(frames))
    got = pipe.restore_segment(torch.from_numpy(frames), deterministic=True)
    assert got.shape == (5, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


# -- dropout -------------------------------------------------------------------


def test_dropout_zero_equals_jax_in_training():
    """p = 0 with a dropout seed (training) is JAX's deterministic=False
    forward for the UNet and the struct-cond encoder."""
    jcfg, net, tree, cfg, sd = _unet("default")
    x, t, ctx, s_cond = _unet_inputs(3)
    want = jax.jit(functools.partial(net.apply, deterministic=False))(
        tree, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        {k: jnp.asarray(v) for k, v in s_cond.items()})
    with torch.no_grad():
        got = _port_unet(cfg, sd)(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx),
                                  {k: nchw(v) for k, v in s_cond.items()}, dropout_seed=7)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-4)

    jsc = tiny_config().structcond
    enc = junet.StructCondEncoder(jsc)
    lat = np.random.RandomState(4).randn(5, 8, 8, 4).astype(np.float32)
    stree = jax_params(enc, lat, t)
    want = jax.jit(functools.partial(enc.apply, deterministic=False))(
        stree, jnp.asarray(lat), jnp.asarray(t))
    scfg = sub(StructCondConfig, jsc)
    port = StructCondEncoder(scfg)
    port.load_state_dict(from_jax.structcond_state_dict(stree, scfg), strict=True)
    with torch.no_grad():
        got = port(nchw(lat), torch.from_numpy(t).long(), dropout_seed=7)
    for key in want:
        np.testing.assert_allclose(to_nhwc(got[key]), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4)


def test_dropout_mask_rate_and_scale():
    """Kept elements are scaled by exactly 1 / (1 - p), the rest are zero,
    the dropped share is p within 4 standard deviations, and one seed gives
    one mask."""
    p, n = 0.3, 1 << 16
    x = torch.ones(n)
    y = layers.dropout(x, p, seed=11)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    share = 1 - kept.float().mean().item()
    assert abs(share - p) < 4 * (p * (1 - p) / n) ** 0.5
    assert torch.equal(layers.dropout(x, p, seed=11), y)
    assert not torch.equal(layers.dropout(x, p, seed=12), y)


def test_dropout_acts_only_in_training():
    """With p > 0: no seed (every restore) is the p = 0 forward bit for bit,
    a seed changes the output, the same seed repeats it, and a
    rematerialised backward (use_checkpoint) draws the same masks. The
    VAE's dropout is inert, as in the JAX package: p > 0 is the p = 0
    encoder and decoder bit for bit, in train mode too."""
    _, _, _, cfg0, sd = _unet("default")
    x, t, ctx, s_cond = _unet_inputs(5)
    args = (nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx),
            {k: nchw(v) for k, v in s_cond.items()})
    ref = _port_unet(cfg0, sd)
    net = _port_unet(dataclasses.replace(cfg0, dropout=0.3), sd)
    with torch.no_grad():
        assert torch.equal(net(*args), ref(*args))
        a, b = net(*args, dropout_seed=3), net(*args, dropout_seed=3)
        assert torch.equal(a, b) and not torch.equal(a, ref(*args))

    def grads(use_checkpoint):
        m = _port_unet(dataclasses.replace(cfg0, dropout=0.3, use_checkpoint=use_checkpoint), sd)
        m(*args, dropout_seed=3).square().mean().backward()
        return {k: p.grad for k, p in m.named_parameters()}

    g0, g1 = grads(False), grads(True)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-7)

    vcfg = VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, dropout=0.3)
    vae = VideoAutoencoderKLResi(vcfg)
    vae0 = VideoAutoencoderKLResi(dataclasses.replace(vcfg, dropout=0.0))
    vae0.load_state_dict(vae.state_dict())
    vae.train()
    img = torch.from_numpy(np.random.RandomState(6).rand(2, 3, 16, 16).astype(np.float32))
    with torch.no_grad():
        moments, fea = vae.encode(img)
        moments0, fea0 = vae0.encode(img)
        assert torch.equal(moments, moments0)
        assert all(torch.equal(a, b) for a, b in zip(fea, fea0))
        z = moments[:, :4]
        assert torch.equal(vae.decode(z, fea), vae0.decode(z, fea0))


def test_trainer_draws_a_dropout_seed_only_with_dropout():
    from mgldvsr_tpu_torch.train.trainer import Stage1Trainer

    for p, drawn in ((0.0, False), (0.1, True)):
        cfg = port_config(tiny_config())
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dropout=p))
        tr = Stage1Trainer(MGLDVSRPipeline(cfg, device="cpu"))
        d = tr.draws(5, 4, 4, torch.Generator().manual_seed(0))
        assert (d.dropout_seed is not None) == drawn
        # the four draws do not move with the fifth
        ref = Stage1Trainer(MGLDVSRPipeline(port_config(tiny_config()), device="cpu"))
        for a, b in zip(d[:4], ref.draws(5, 4, 4, torch.Generator().manual_seed(0))[:4]):
            assert torch.equal(a, b)


# -- the image VAE, the dilated temporal conv, the ViT-L text tower ------------


def test_autoencoder_kl_matches_jax():
    jcfg = jvae.VAEConfig(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
    net = jvae.AutoencoderKL(jcfg)
    x = (np.random.RandomState(7).rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    tree = jax_params(net, x)
    cfg = sub(VAEConfig, jcfg)
    sd = from_jax.vae_state_dict(tree, cfg)
    assert_round_trip(tree, sd, lambda d, **k: ckpt_convert.convert_autoencoder(
        d, prefix="", video=False, fusion=False, ch_mult=jcfg.ch_mult,
        num_res_blocks=jcfg.num_res_blocks, **k))
    port = AutoencoderKL(cfg)
    port.load_state_dict(sd, strict=True)
    want_m = jax.jit(functools.partial(net.apply, method="encode_moments"))(tree, jnp.asarray(x))
    want = jax.jit(net.apply)(tree, jnp.asarray(x))
    with torch.no_grad():
        got_m = port.encode_moments(nchw(x))
        got = port(nchw(x))
    np.testing.assert_allclose(to_nhwc(got_m), np.asarray(want_m), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-4, atol=2e-4)


def test_multidim_temporal_conv_matches_jax():
    """Forward against JAX, and the upstream keys (``temporal_conv1/2``,
    ``temporal_alpha``) back to the JAX tree through ckpt_convert's kernel
    layout bit for bit."""
    net = jtemporal.MultiDimTemporalConv(num_frames=5)
    x = np.random.RandomState(8).randn(10, 4, 4, 16).astype(np.float32)
    tree = jax_params(net, x)
    sd = from_jax.multidim_temporal_conv_state_dict(tree)
    p = tree["params"]
    for name in ("temporal_conv1", "temporal_conv2"):
        np.testing.assert_array_equal(ckpt_convert.conv_kernel(sd[f"{name}.weight"]),
                                      p[name]["kernel"])
        np.testing.assert_array_equal(sd[f"{name}.bias"].numpy(), p[name]["bias"])
    np.testing.assert_array_equal(sd["temporal_alpha"].numpy(), p["alpha"])
    port = MultiDimTemporalConv(16, 5)
    port.load_state_dict(sd, strict=True)
    want = jax.jit(net.apply)(tree, jnp.asarray(x))
    with torch.no_grad():
        got = port(nchw(x))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def _hf_clip(tree, n_layers, prefix="cond_stage_model.transformer."):
    """A Hugging Face CLIPTextModel state dict holding ``tree``'s weights
    (q, k, v split out of the fused in-projection), position_ids included."""
    p = tree["params"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    base = f"{prefix}text_model."
    hf = {f"{base}embeddings.token_embedding.weight": t(p["token_embedding"]),
          f"{base}embeddings.position_embedding.weight": t(p["positional_embedding"]),
          f"{base}embeddings.position_ids": torch.arange(77)[None],
          f"{base}final_layer_norm.weight": t(p["ln_final"]["scale"]),
          f"{base}final_layer_norm.bias": t(p["ln_final"]["bias"])}
    for i in range(n_layers):
        b, a = p[f"resblock_{i}"], f"{base}encoder.layers.{i}."
        for hf_name, ours in (("layer_norm1", "ln_1"), ("layer_norm2", "ln_2")):
            hf[f"{a}{hf_name}.weight"] = t(b[ours]["scale"])
            hf[f"{a}{hf_name}.bias"] = t(b[ours]["bias"])
        w = b["attn_in_proj"]["kernel"].T
        bias = b["attn_in_proj"]["bias"]
        for j, n in enumerate("qkv"):
            rows = slice(j * w.shape[1], (j + 1) * w.shape[1])
            hf[f"{a}self_attn.{n}_proj.weight"] = t(w[rows])
            hf[f"{a}self_attn.{n}_proj.bias"] = t(bias[rows])
        for hf_name, ours in (("self_attn.out_proj", "attn_out_proj"), ("mlp.fc1", "mlp_c_fc"),
                              ("mlp.fc2", "mlp_c_proj")):
            hf[f"{a}{hf_name}.weight"] = t(b[ours]["kernel"].T)
            hf[f"{a}{hf_name}.bias"] = t(b[ours]["bias"])
    return hf


def test_vit_l_config_equals_jax():
    want = jclip.frozen_clip_vit_l_config()
    got = frozen_clip_vit_l_config()
    for f in dataclasses.fields(want):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.dtype == torch.float32
    assert frozen_clip_vit_l_config(torch.bfloat16).dtype == torch.bfloat16


def test_hf_clip_text_loads_as_the_jax_converter_reads_it():
    """A ViT-L-shaped tower at tiny width (quick-gelu, the last layer):
    Hugging Face keys -> the port's names equal from_jax's for the same
    tree (which convert_hf_clip_text reads back bit for bit), load strictly
    through load_mgld_checkpoint, and the forward matches JAX."""
    jcfg = dataclasses.replace(jclip.frozen_clip_vit_l_config(), width=32, heads=2, layers=2)
    net = jclip.OpenCLIPTextEncoder(jcfg)
    tokens = jclip.empty_prompt_tokens(2)
    tree = jax_params(net, tokens)
    hf = _hf_clip(tree, jcfg.layers)
    back = ckpt_convert.convert_hf_clip_text(hf, layers=jcfg.layers)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        got = functools.reduce(lambda n, k: n[k.key], path, back)
        np.testing.assert_array_equal(np.asarray(got), leaf, err_msg=str(path))
    cfg = sub(CLIPTextConfig, jcfg)
    want_sd = from_jax.clip_state_dict(tree, cfg)
    got_sd = torch_ckpt.hf_clip_text_state_dict(hf)
    assert set(got_sd) == set(want_sd)
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k
    with pytest.raises(KeyError, match="not read"):
        torch_ckpt.hf_clip_text_state_dict({**hf, "cond_stage_model.transformer.text_model.x": hf[
            "cond_stage_model.transformer.text_model.final_layer_norm.bias"]})

    pcfg = dataclasses.replace(port_config(tiny_config()), clip=cfg)
    pipe = MGLDVSRPipeline(pcfg, device="cpu")
    torch_ckpt.load_mgld_checkpoint(pipe, hf, towers=("clip",))
    want = jax.jit(net.apply)(tree, tokens)
    with torch.no_grad():
        got = pipe.clip(empty_prompt_tokens(2, device="cpu"))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert isinstance(pipe.clip, OpenCLIPTextEncoder)


# -- the config loader and the CLIs --------------------------------------------


@pytest.mark.parametrize("name", ["unet", "structcond", "vae", "clip", "raft", "pipeline"])
def test_config_takes_every_jax_field(name):
    """Every field of the JAX dataclass is one of the port's, with the same
    default (dtype by name)."""
    pairs = {"unet": (junet.UNetConfig(), UNetConfig()),
             "structcond": (junet.StructCondConfig(), StructCondConfig()),
             "vae": (jvae.VAEConfig(), VAEConfig()),
             "clip": (jclip.CLIPTextConfig(), CLIPTextConfig()),
             "raft": (JaxRAFTConfig(), RAFTConfig()),
             "pipeline": (JaxPipelineConfig(), PipelineConfig())}
    want, got = pairs[name]
    for f in dataclasses.fields(want):
        assert hasattr(got, f.name), f.name
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "dtype":
            assert str(g).replace("torch.", "") == str(np.dtype(w))
        elif not dataclasses.is_dataclass(w):
            assert g == w, f.name


def test_tpu_only_options_are_refused_by_name():
    cfg = pconfig.pipeline_config_from_dict(
        {"vae": {"remat_min_res": 0}, "raft": {"lookup_impl": "auto"}})
    assert cfg.vae.remat_min_res == 0 and cfg.raft.lookup_impl == "auto"
    with pytest.raises(ValueError, match="use_checkpoint"):
        pconfig.pipeline_config_from_dict({"vae": {"remat_min_res": 256}})
    for impl in ("xla", "pallas"):
        with pytest.raises(ValueError, match=f"lookup_impl='{impl}'"):
            pconfig.pipeline_config_from_dict({"raft": {"lookup_impl": impl}})


def test_bool_options_take_true_and_false():
    """``--set model.unet.use_temporal=false`` reaches the loader as the
    string "false" (not a Python literal): the port makes it False; the JAX
    loader keeps the string, which is truthy (a fault of the reference)."""
    sets = ["model.unet.use_temporal=false", "model.unet.use_spade=FALSE",
            "model.unet.use_linear_in_transformer=False", "model.unet.dropout=0.1"]
    model = pconfig.load_config([], sets)["model"]
    cfg = pconfig.pipeline_config_from_dict(model)
    assert (cfg.unet.use_temporal, cfg.unet.use_spade, cfg.unet.use_linear_in_transformer,
            cfg.unet.dropout) == (False, False, False, 0.1)
    from mgldvsr_tpu.utils import config as jconfig
    assert jconfig.pipeline_config_from_dict(model).unet.use_temporal == "false"
    with pytest.raises(ValueError, match="not a bool"):
        pconfig.pipeline_config_from_dict({"unet": {"use_spade": "no"}})


def test_options_pass_through_both_clis(tmp_path):
    """Every new option through --set in the inference CLI and the
    training CLI, on the tiny preset and the full one (config only)."""
    sets = ["model.unet.use_temporal=false", "model.unet.use_spade=false",
            "model.unet.use_linear_in_transformer=false", "model.unet.dropout=0.1",
            "model.structcond.dropout=0.2", "model.vae.dropout=0.3",
            "model.vae.remat_min_res=0", "model.raft.lookup_impl=auto"]
    argv = [x for s in sets for x in ("--set", s)]

    def check(cfg):
        assert (cfg.unet.use_temporal, cfg.unet.use_spade,
                cfg.unet.use_linear_in_transformer) == (False, False, False)
        assert (cfg.unet.dropout, cfg.structcond.dropout, cfg.vae.dropout) == (0.1, 0.2, 0.3)

    for preset in ("tiny", "full"):
        args = infer_cli.parse_args(["--seqs-path", "x", "--out-path", "y", "--device", "cpu",
                                     "--preset", preset, *argv])
        if preset == "tiny":
            check(infer_cli.build_pipeline(args).cfg)
        else:
            check(pconfig.pipeline_config_from_dict(args.model_cfg))
    for tiny in (["--tiny"], []):
        args = train_cli.parse_args(["--data-root", str(tmp_path), "--device", "cpu",
                                     *tiny, *argv])
        if tiny:
            check(train_cli.build_pipeline(args).cfg)
        else:
            check(pconfig.pipeline_config_from_dict(args.cfg["model"]))
    bad = train_cli.parse_args(["--data-root", str(tmp_path), "--device", "cpu", "--tiny",
                                "--set", "model.raft.lookup_impl=pallas"])
    with pytest.raises(ValueError, match="lookup_impl"):
        train_cli.build_pipeline(bad)


def test_cli_runs_the_image_sr_unet(tmp_path):
    """One tiny restore through the inference CLI with the temporal layers
    off: five frames written, and its pipeline's UNet has no temporal
    module."""
    seqs = str(tmp_path / "lq")
    _write_clip(seqs, "clip0", 5, 16, 16)
    argv = ["--seqs-path", seqs, "--out-path", str(tmp_path / "out"), "--preset", "tiny",
            "--ddpm-steps", "1", "--no-bf16", "--device", "cpu",
            "--set", "model.unet.use_temporal=false"]
    infer_cli.main(argv)
    names = sorted(os.listdir(tmp_path / "out" / "clip0"))
    assert len(names) == 5 and all(n.endswith(".png") for n in names)
    pipe = infer_cli.build_pipeline(infer_cli.parse_args(argv))
    assert not pipe.cfg.unet.use_temporal
    assert not any("temporal" in k for k in pipe.unet.state_dict())

"""Port towers (mgldvsr_tpu_torch.models, flow.raft) against their JAX
modules at tiny widths, float32 on the CPU, with the same seeded weights
(JAX init -> io.from_jax -> port) and the same numpy inputs. Also the
from_jax <-> ckpt_convert round trip, which must be exact.

Tolerances: both sides run float32 with JAX at 'highest' matmul precision,
but convolutions, matmuls and reductions sum in other orders, and the
errors grow through a tower's depth; each tolerance below is a few times
the largest difference observed, and orders of magnitude below the
activations' scale.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.infer.pipeline import MGLDVSRPipeline as JaxPipeline
from mgldvsr_tpu.io import ckpt_convert
from mgldvsr_tpu_torch.flow.raft import RAFT, RAFTConfig
from mgldvsr_tpu_torch.infer.pipeline import PipelineConfig
from mgldvsr_tpu_torch.io import from_jax
from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig, OpenCLIPTextEncoder
from mgldvsr_tpu_torch.models.unet import (
    InflatedUNetDualCond,
    StructCondConfig,
    StructCondEncoder,
    UNetConfig,
)
from mgldvsr_tpu_torch.models.vae import VAEConfig, VideoAutoencoderKLResi
from tests.test_pipeline import tiny_config


def port_config(jcfg) -> PipelineConfig:
    """The port PipelineConfig with every field the JAX one shares (all
    float32)."""

    def sub(cls, j):
        names = {f.name for f in dataclasses.fields(cls)} - {"dtype"}
        return cls(**{n: getattr(j, n) for n in names})

    top = {f.name for f in dataclasses.fields(PipelineConfig)} - {
        "unet", "structcond", "vae", "clip", "raft"}
    return PipelineConfig(
        **{n: getattr(jcfg, n) for n in top},
        unet=sub(UNetConfig, jcfg.unet), structcond=sub(StructCondConfig, jcfg.structcond),
        vae=sub(VAEConfig, jcfg.vae), clip=sub(CLIPTextConfig, jcfg.clip),
        raft=sub(RAFTConfig, jcfg.raft))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def jax_pipeline_and_params(jcfg, size=32, seed=0):
    pipe = JaxPipeline(jcfg)
    params = pipe.init_params(jax.random.PRNGKey(seed), size, size)
    return pipe, params


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def to_nhwc(x: torch.Tensor) -> np.ndarray:
    return t2n(x.permute(0, 2, 3, 1))


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_config(num_frames=5, ddpm_steps=2)
    jpipe, params = jax_pipeline_and_params(jcfg)
    cfg = port_config(jcfg)
    sds = from_jax.pipeline_state_dicts(numpy_tree(params), cfg)
    return jcfg, jpipe, params, cfg, sds


def test_unet_forward_matches_jax(tiny):
    jcfg, jpipe, params, cfg, sds = tiny
    rs = np.random.RandomState(0)
    x = rs.randn(5, 8, 8, 4).astype(np.float32)
    t = np.array([999, 500, 10, 0, 250], np.int32)
    ctx = rs.randn(5, 77, 32).astype(np.float32)
    s_cond = {"8": rs.randn(5, 8, 8, 32).astype(np.float32),
              "4": rs.randn(5, 4, 4, 32).astype(np.float32)}
    want = jax.jit(jpipe.unet.apply)(params["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                            {k: jnp.asarray(v) for k, v in s_cond.items()})
    net = InflatedUNetDualCond(cfg.unet)
    net.load_state_dict(sds["unet"], strict=True)
    with torch.no_grad():
        got = net(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx),
                  {k: nchw(v) for k, v in s_cond.items()})
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert np.abs(np.asarray(want)).max() > 1e-2  # random out conv: output is not zero


def test_structcond_forward_matches_jax(tiny):
    jcfg, jpipe, params, cfg, sds = tiny
    rs = np.random.RandomState(1)
    x = rs.randn(5, 8, 8, 4).astype(np.float32)
    t = np.array([999, 700, 300, 20, 0], np.int32)
    want = jax.jit(jpipe.structcond.apply)(params["structcond"], jnp.asarray(x), jnp.asarray(t))
    net = StructCondEncoder(cfg.structcond)
    net.load_state_dict(sds["structcond"], strict=True)
    with torch.no_grad():
        got = net(nchw(x), torch.from_numpy(t).long())
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(to_nhwc(got[key]), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4)


def test_vae_encode_decode_match_jax(tiny):
    jcfg, jpipe, params, cfg, sds = tiny
    rs = np.random.RandomState(2)
    x = (rs.rand(5, 32, 32, 3) * 2 - 1).astype(np.float32)
    moments, fea = jax.jit(functools.partial(jpipe.vae.apply, method="encode"))(
        params["vae"], jnp.asarray(x))
    net = VideoAutoencoderKLResi(cfg.vae)
    net.load_state_dict(sds["vae"], strict=True)
    with torch.no_grad():
        got_m, got_fea = net.encode(nchw(x))
    np.testing.assert_allclose(to_nhwc(got_m), np.asarray(moments), rtol=1e-4, atol=1e-4)
    assert len(got_fea) == len(fea) == 2
    for g, w in zip(got_fea, fea):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), rtol=1e-4, atol=1e-4)

    z = rs.randn(5, 4, 4, 4).astype(np.float32)
    want = jax.jit(functools.partial(jpipe.vae.apply, method="decode"))(
        params["vae"], jnp.asarray(z), fea, 0.7)
    with torch.no_grad():
        got = net.decode(nchw(z), [nchw(np.asarray(f)) for f in fea], 0.7)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-4, atol=2e-4)


def test_clip_matches_jax(tiny):
    from mgldvsr_tpu.models.cliptext import empty_prompt_tokens as jax_tokens
    from mgldvsr_tpu_torch.models.cliptext import empty_prompt_tokens

    jcfg, jpipe, params, cfg, sds = tiny
    tokens = empty_prompt_tokens(3)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jax_tokens(3)))
    want = jax.jit(jpipe.clip.apply)(params["clip"], jax_tokens(3))
    net = OpenCLIPTextEncoder(cfg.clip)
    net.load_state_dict(sds["clip"], strict=True)
    with torch.no_grad():
        got = net(tokens)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_raft_matches_jax(tiny):
    """RAFT at a size that is not a multiple of 8 (edge padding) and whose
    coarsest pyramid level is empty."""
    jcfg, jpipe, params, cfg, sds = tiny
    rs = np.random.RandomState(3)
    a = rs.rand(2, 30, 36, 3).astype(np.float32)
    b = np.roll(a, 2, axis=2) * 0.9 + 0.05
    want = jax.jit(jpipe.raft.apply)(params["raft"], jnp.asarray(a), jnp.asarray(b))
    net = RAFT(cfg.raft)
    net.load_state_dict(sds["raft"], strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (2, 30, 36, 2)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-3, atol=1e-3)


def _round_trip(tree, sd, convert, **kwargs):
    used: set = set()
    back = convert({k: v.numpy() for k, v in sd.items()}, prefix="", used=used, **kwargs)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert flat_back.keys() == flat_want.keys()
    for path, want in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(want),
                                      err_msg=str(path))
    assert used == set(sd), sorted(set(sd) - used)


@pytest.mark.parametrize("tower", ["unet", "structcond", "vae", "clip", "raft"])
def test_from_jax_round_trip_is_exact(tiny, tower):
    """JAX params -> from_jax -> ckpt_convert.convert_* reproduces the JAX
    tree bit for bit and consumes every port key; the port module takes
    the state dict strictly."""
    jcfg, jpipe, params, cfg, sds = tiny
    tree = numpy_tree(params[tower])
    sd = sds[tower]
    u, s, v = jcfg.unet, jcfg.structcond, jcfg.vae
    convert = {
        "unet": lambda d, **k: ckpt_convert.convert_unet(
            d, channel_mult=u.channel_mult, num_res_blocks=u.num_res_blocks,
            attention_resolutions=u.attention_resolutions,
            transformer_depth=u.transformer_depth, **k),
        "structcond": lambda d, **k: ckpt_convert.convert_structcond(
            d, channel_mult=s.channel_mult, model_channels=s.model_channels,
            num_res_blocks=s.num_res_blocks, attention_resolutions=s.attention_resolutions,
            num_heads=s.num_heads, **k),
        "vae": lambda d, **k: ckpt_convert.convert_autoencoder(
            d, video=True, fusion=True, ch_mult=v.ch_mult, num_res_blocks=v.num_res_blocks,
            attn_resolutions=v.attn_resolutions, resolution=v.resolution, **k),
        "clip": lambda d, **k: ckpt_convert.convert_openclip_text(
            d, layers=jcfg.clip.layers, penultimate=jcfg.clip.layer == "penultimate", **k),
        "raft": ckpt_convert.convert_raft,
    }[tower]
    _round_trip(tree, sd, convert)
    module = {"unet": lambda: InflatedUNetDualCond(cfg.unet),
              "structcond": lambda: StructCondEncoder(cfg.structcond),
              "vae": lambda: VideoAutoencoderKLResi(cfg.vae),
              "clip": lambda: OpenCLIPTextEncoder(cfg.clip),
              "raft": lambda: RAFT(cfg.raft)}[tower]()
    module.load_state_dict(sd, strict=True)
    assert set(module.state_dict()) == set(sd)


def test_seeded_init_statistics():
    """The device-side initializer: zeros and ones only where the JAX fast
    init puts them, fan-in-scaled normals elsewhere (so the UNet's output
    conv, zero in upstream, is random), and the same seed gives the same
    weights."""
    from mgldvsr_tpu_torch.io.init_weights import init_module_weights

    cfg = port_config(tiny_config()).unet
    a = init_module_weights(InflatedUNetDualCond(cfg), torch.Generator().manual_seed(5))
    b = init_module_weights(InflatedUNetDualCond(cfg), torch.Generator().manual_seed(5))
    sda, sdb = a.state_dict(), b.state_dict()
    for k in sda:
        assert torch.equal(sda[k], sdb[k]), k
    assert torch.all(sda["out.2.bias"] == 0)
    assert torch.all(sda["out.0.weight"] == 1)
    assert torch.all(sda["middle_block.1.temporal_alpha"] == 0)
    w = sda["out.2.weight"]  # [4, 32, 3, 3]: fan_in 288
    assert abs(w.std().item() - 288 ** -0.5) < 0.2 * 288 ** -0.5

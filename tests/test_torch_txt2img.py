"""The stock text-to-image path against the JAX package, on the CPU,
float32: DDIM (eta 0, and eta > 0 with JAX's noises injected), DDIM
inversion and PLMS with an analytic ``denoise_fn`` (1e-5), the CLIP BPE
tokenizer on a made-up merges file (ids equal), and the tiny
``Text2ImgPipeline`` (``tests/test_txt2img.py``'s configuration, weights
drawn once and converted through ``io.from_jax``): ``generate`` under
classifier-free guidance 3.0 with ``x_T`` injected, 2 DDIM steps, then
``invert`` of the image with JAX's posterior noise (2e-4, as PERF.md
holds the tiny restore).
"""
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.core import samplers as jsam
from mgldvsr_tpu.core.schedules import DiffusionSchedule as JSchedule
from mgldvsr_tpu.data import tokenizer as jtok
from mgldvsr_tpu.infer import txt2img as jt2i
from mgldvsr_tpu.models.cliptext import CLIPTextConfig as JCLIPTextConfig
from mgldvsr_tpu.models.unet import UNetConfig as JUNetConfig
from mgldvsr_tpu.models.vae import VAEConfig as JVAEConfig
from mgldvsr_tpu_torch.core import samplers
from mgldvsr_tpu_torch.core.schedules import DiffusionSchedule
from mgldvsr_tpu_torch.data import tokenizer
from mgldvsr_tpu_torch.infer import txt2img
from mgldvsr_tpu_torch.io import from_jax
from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig
from mgldvsr_tpu_torch.models.unet import UNetConfig
from mgldvsr_tpu_torch.models.vae import VAEConfig

torch.set_num_threads(1)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


# -- samplers ----------------------------------------------------------------


def _scheds():
    kw = dict(timesteps=100, beta_schedule="linear", linear_start=0.00085, linear_end=0.012)
    return JSchedule.create(**kw), DiffusionSchedule.create(**kw, device="cpu")


W = np.random.RandomState(0).standard_normal((4, 4)).astype(np.float32) * 0.05


def _jax_fn(x, tb):
    tt = (tb.astype(jnp.float32) / 100.0)[:, None, None, None]
    return x @ W + 0.1 * tt


def _port_fn(x, tb):
    tt = (tb.float() / 100.0)[:, None, None, None]
    return x @ torch.from_numpy(W) + 0.1 * tt


X = np.random.RandomState(1).standard_normal((2, 8, 8, 4)).astype(np.float32)


def test_ddim_step_grid_has_no_plus_one():
    """The JAX package's grid, range(0, n, n // steps): upstream's
    ``make_ddim_timesteps`` adds 1 (ROADMAP section 3 keeps the question)."""
    np.testing.assert_array_equal(samplers.make_ddim_timesteps(1000, 50),
                                  np.arange(0, 1000, 20))
    np.testing.assert_array_equal(samplers.make_ddim_timesteps(100, 10),
                                  jsam.make_ddim_timesteps(100, 10))


@pytest.mark.parametrize("eta", [0.0, 0.7])
def test_ddim_matches_jax(eta):
    """eta > 0: each step's noise is JAX's draw, injected."""
    js, ps = _scheds()
    key = jax.random.PRNGKey(3)
    want = jsam.ddim_sample(js, _jax_fn, jnp.asarray(X), key, num_steps=10, eta=eta)
    noises, k = [], key
    for _ in range(10):
        k, sub = jax.random.split(k)
        noises.append(torch.from_numpy(np.array(jax.random.normal(sub, X.shape))))
    got = samplers.ddim_sample(ps, _port_fn, torch.from_numpy(X), num_steps=10, eta=eta,
                               noises=noises)
    _close(got, want, 1e-5)


def test_ddim_invert_and_plms_match_jax():
    js, ps = _scheds()
    _close(samplers.ddim_invert(ps, _port_fn, torch.from_numpy(X), num_steps=10),
           jsam.ddim_invert(js, _jax_fn, jnp.asarray(X), num_steps=10), 1e-5)
    _close(samplers.plms_sample(ps, _port_fn, torch.from_numpy(X), num_steps=10),
           jsam.plms_sample(js, _jax_fn, jnp.asarray(X), num_steps=10), 1e-5)


def test_ddim_draws_from_the_generator():
    _, ps = _scheds()
    x = torch.from_numpy(X)

    def run(seed, eta):
        return samplers.ddim_sample(ps, _port_fn, x, torch.Generator().manual_seed(seed),
                                    num_steps=5, eta=eta)

    assert torch.equal(run(1, 0.0), run(2, 0.0))
    assert torch.equal(run(1, 1.0), run(1, 1.0)) and not torch.equal(run(1, 1.0), run(2, 1.0))


# -- the tokenizer -----------------------------------------------------------


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    """A made-up merges file: a header line, then merges that build a few
    words of the prompts below from their letters."""
    words = ["hello", "world", "photo", "cat", "of", "a", "the", "tpu", "on"]
    lines, seen = ["#version: made up"], set()
    for w in words:
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            pair = (parts[0], parts[1])
            if pair not in seen:
                seen.add(pair)
                lines.append(" ".join(pair))
            parts = [parts[0] + parts[1]] + parts[2:]
    path = tmp_path_factory.mktemp("bpe") / "bpe_made_up.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


PROMPTS = ["a photo of a cat", "Hello, World!  2 cats &amp; 1 TPU", "", "héllo wörld 42",
           "the cat on the cat on the cat on the cat on the cat"]


def test_tokenizer_ids_equal_jax(merges):
    ours, theirs = tokenizer.SimpleTokenizer(merges), jtok.SimpleTokenizer(merges)
    for text in PROMPTS:
        assert ours.encode(text) == theirs.encode(text), text
        assert ours.decode(ours.encode(text)) == theirs.decode(theirs.encode(text))
    for n in (77, 8):  # 8 truncates: the last id stays EOT
        got = tokenizer.tokenize(PROMPTS, context_length=n, tokenizer=ours)
        np.testing.assert_array_equal(got, jtok.tokenize(PROMPTS, context_length=n,
                                                         tokenizer=theirs))
    assert got[4, -1] == tokenizer.EOT_TOKEN and got[4, 0] == tokenizer.SOT_TOKEN
    with pytest.raises(ValueError, match="bpe_path"):
        tokenizer.tokenize(["a cat"])


# -- the tiny pipeline -------------------------------------------------------


def _configs():
    unet = dict(model_channels=32, num_head_channels=16, context_dim=32, semb_channels=32,
                channel_mult=(1, 2), attention_resolutions=(1, 2), num_frames=1,
                use_temporal=False, use_spade=False)
    vae = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, num_frames=1, enable_fusion=False)
    clip = dict(width=32, heads=2, layers=2, context_length=8, vocab_size=64)
    return (jt2i.Text2ImgConfig(timesteps=100, unet=JUNetConfig(**unet), vae=JVAEConfig(**vae),
                                clip=JCLIPTextConfig(**clip)),
            txt2img.Text2ImgConfig(timesteps=100, unet=UNetConfig(**unet), vae=VAEConfig(**vae),
                                   clip=CLIPTextConfig(**clip)))


def _drawn(shapes, seed):
    """Weights of the given shapes: kernels N(0, 1/fan_in), norm scales
    about 1, everything else 0.05 N(0, 1), so that no branch is zero."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        if getattr(path[-1], "key", None) == "scale":
            return (1 + 0.05 * rs.randn(*s.shape)).astype(np.float32)
        if len(s.shape) >= 2:
            return (rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.05 * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tiny():
    jcfg, pcfg = _configs()
    jpipe = jt2i.Text2ImgPipeline(jcfg)
    params = _drawn(jax.eval_shape(lambda k: jpipe.init_params(k, 64, 64), jax.random.PRNGKey(0)), 0)
    pipe = txt2img.Text2ImgPipeline(pcfg, device="cpu")
    pipe.unet.load_state_dict(from_jax.unet_state_dict(params["unet"], pcfg.unet))
    pipe.vae.load_state_dict(from_jax.vae_state_dict(params["vae"], pcfg.vae))
    pipe.clip.load_state_dict(from_jax.clip_state_dict(params["clip"], pcfg.clip))
    pipe.cast_to_compute_dtypes()
    tokens = np.zeros((2, 8), np.int32)
    tokens[:, 0], tokens[:, 1], tokens[1, 2] = 5, 7, 9
    x_T = np.random.RandomState(1).standard_normal((2, 8, 8, 4)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    img = jpipe.generate(params, jnp.asarray(tokens), key, uncond_tokens=jnp.zeros((2, 8),
                         jnp.int32), cfg_scale=3.0, height=64, width=64, num_steps=2,
                         x_T=jnp.asarray(x_T))
    img = np.clip(np.asarray(img), -1, 1)
    ctx = jpipe.embed_tokens(params, jnp.asarray(tokens))
    inv = jpipe.invert(params, jnp.asarray(img), ctx, key, num_steps=2)
    noise = np.array(jax.random.normal(key, (2, 8, 8, 4)))  # the posterior draw of invert
    return dict(pipe=pipe, tokens=tokens, x_T=x_T, img=img, inv=np.asarray(inv), noise=noise)


def test_tiny_pipeline_generates_as_jax(tiny):
    pipe = tiny["pipe"]
    got = pipe.generate(torch.from_numpy(tiny["tokens"]),
                        uncond_tokens=torch.zeros(2, 8, dtype=torch.int64), cfg_scale=3.0,
                        height=64, width=64, num_steps=2, x_T=torch.from_numpy(tiny["x_T"]))
    assert got.shape == (2, 64, 64, 3)
    _close(got.clamp(-1, 1), tiny["img"], 2e-4)
    plain = pipe.generate(torch.from_numpy(tiny["tokens"]), height=64, width=64, num_steps=2,
                          x_T=torch.from_numpy(tiny["x_T"]))
    assert float((plain - got).abs().max()) > 1e-3  # guidance moves the trajectory


def test_tiny_pipeline_inverts_as_jax(tiny):
    pipe = tiny["pipe"]
    ctx = pipe.embed_tokens(torch.from_numpy(tiny["tokens"]))
    got = pipe.invert(torch.from_numpy(tiny["img"]), ctx, num_steps=2,
                      noise=torch.from_numpy(tiny["noise"]))
    _close(got, tiny["inv"], 2e-4)


def test_text2img_refuses_the_vsr_unet():
    with pytest.raises(ValueError, match="stock UNet"):
        txt2img.Text2ImgPipeline(txt2img.Text2ImgConfig(unet=UNetConfig()), device="cpu")

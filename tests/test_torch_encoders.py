"""Textual inversion, the alternate encoders and the noisy-latent
classifier against the JAX package, on the CPU, float32, tiny widths, each
port module filled from the JAX module's parameters through
``io.from_jax``. Limit: 2e-5 on every output (the tests' outputs are O(1)).
The CLIP image tower's converter is the exact inverse of
``convert_clip_image``: a state dict goes through JAX's converter and back
bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.io import ckpt_convert as cc
from mgldvsr_tpu.models import classifier as jcls
from mgldvsr_tpu.models import encoders as jenc
from mgldvsr_tpu.models import textual_inversion as jti
from mgldvsr_tpu.models.cliptext import CLIPTextConfig as JCLIPTextConfig
from mgldvsr_tpu.models.cliptext import OpenCLIPTextEncoder as JCLIP
from mgldvsr_tpu_torch.io import from_jax
from mgldvsr_tpu_torch.models import classifier as pcls
from mgldvsr_tpu_torch.models import encoders as penc
from mgldvsr_tpu_torch.models import textual_inversion as pti
from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig, OpenCLIPTextEncoder

torch.set_num_threads(1)
ATOL = 2e-5


def _drawn(module, seed, *args, **kwargs):
    """Parameters of the shapes ``module.init`` gives (traced, not
    compiled): kernels N(0, 1/fan_in), norm scales about 1, every other
    leaf 0.05 N(0, 1), so that no branch is zero."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs), jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        if getattr(path[-1], "key", None) == "scale":
            return (1 + 0.05 * rs.randn(*s.shape)).astype(np.float32)
        if len(s.shape) >= 2:
            return (rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.05 * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=atol, rtol=0)


# -- textual inversion -------------------------------------------------------


def test_placeholder_init_equals_jax():
    ph = {"*": 5, "&": 9}
    got = pti.init_placeholder_params(ph, 8, num_vectors_per_token=3, seed=1,
                                      init_embeddings={"&": np.arange(8.0)})
    want = jti.init_placeholder_params(ph, 8, num_vectors_per_token=3, seed=1,
                                       init_embeddings={"&": np.arange(8.0)})
    for k in ph:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_single_vector_through_the_text_tower_matches_jax():
    """The learned row substituted at the token embedding's output, then
    the text tower, against JAX's substitution fed through its own tower's
    blocks; the gradient reaches the learned row."""
    jcfg = JCLIPTextConfig(width=32, heads=2, layers=3, context_length=8, vocab_size=64)
    pcfg = CLIPTextConfig(width=32, heads=2, layers=3, context_length=8, vocab_size=64)
    tokens = np.array([[1, 5, 2, 0, 0, 0, 0, 0], [5, 5, 3, 9, 0, 0, 0, 0]], np.int32)
    jparams = _drawn(JCLIP(jcfg), 0, jnp.asarray(tokens))
    ph = {"*": 5, "&": 9}
    learned = jti.init_placeholder_params(ph, 32, seed=2)

    def jax_forward(rows):
        p = jparams["params"]
        emb = jti.apply_single_vector(rows, ph, jnp.asarray(tokens),
                                      jnp.asarray(p["token_embedding"])[tokens])
        # JAX's tower indexes its table itself: hand it a table whose rows
        # at fresh ids are the substituted embeddings
        table = jnp.concatenate([jnp.asarray(p["token_embedding"]), emb.reshape(-1, 32)])
        ids = 64 + jnp.arange(tokens.size).reshape(tokens.shape)
        big = JCLIP(jcfg.__class__(**{**jcfg.__dict__, "vocab_size": 64 + tokens.size}))
        return big.apply({"params": {**p, "token_embedding": table}}, ids)

    # one jit: the output and its gradient in the learned rows
    grad_fn = jax.jit(jax.grad(lambda r: (jax_forward(r).sum(), jax_forward(r)), has_aux=True))
    gwant, want = grad_fn(learned)
    tower = OpenCLIPTextEncoder(pcfg).eval()
    tower.load_state_dict(from_jax.clip_state_dict(jparams, pcfg))
    rows = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in learned.items()}
    t = torch.from_numpy(tokens).long()
    got = tower(t, pti.apply_single_vector(rows, ph, t, tower.token_embedding(t)))
    _close(got, want)
    got.sum().backward()
    for k in ph:
        _close(rows[k].grad, gwant[k], 1e-4)
        assert float(rows[k].grad.abs().max()) > 0


def test_multi_vector_and_regularisers_equal_jax():
    params = {"*": np.arange(8, dtype=np.float32).reshape(2, 4) + 100,
              "&": np.arange(12, dtype=np.float32).reshape(3, 4) - 7}
    ph = {"*": 9, "&": 4}
    tokens = np.array([[1, 9, 2, 4, 3, 9], [4, 9, 0, 0, 0, 0]])
    embedded = np.random.RandomState(0).rand(2, 6, 4).astype(np.float32)
    for counter in (None, 0, 2500):
        got = pti.expand_multi_vector({k: torch.from_numpy(v) for k, v in params.items()}, ph,
                                      tokens, embedded, counter)
        want = jti.expand_multi_vector({k: jnp.asarray(v) for k, v in params.items()}, ph,
                                       tokens, embedded, counter)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    _close(pti.embedding_norms_squared(tp), jti.embedding_norms_squared(params), 1e-3)
    init = {k: np.zeros_like(v) + 1.5 for k, v in params.items()}
    _close(pti.coarse_init_loss(tp, init), jti.coarse_init_loss(params, init), 1e-2)


# -- encoders ----------------------------------------------------------------


def _port(module, jmodule, x, seed, *args):
    params = _drawn(jmodule, seed, x, *args)
    module.load_state_dict(from_jax.encoders_state_dict(params, module))
    return params


def test_class_embedder_matches_jax():
    ids = np.array([1, 7, 3])
    m = penc.ClassEmbedder(16, n_classes=10)
    jm = jenc.ClassEmbedder(embed_dim=16, n_classes=10)
    params = _port(m, jm, jnp.asarray(ids), 0)
    _close(m(torch.from_numpy(ids)), jm.apply(params, jnp.asarray(ids)))


def test_transformer_text_embedder_matches_jax():
    jcfg = jenc.TransformerTextConfig(vocab_size=100, width=32, depth=2, heads=2, max_seq_len=16)
    pcfg = penc.TransformerTextConfig(vocab_size=100, width=32, depth=2, heads=2, max_seq_len=16)
    toks = (np.arange(24).reshape(2, 12) * 7) % 100
    jm = jenc.TransformerTextEmbedder(jcfg)
    m = penc.TransformerTextEmbedder(pcfg)
    params = _port(m, jm, jnp.asarray(toks), 1)
    _close(m(torch.from_numpy(toks)), jm.apply(params, jnp.asarray(toks)))


@pytest.mark.parametrize("out_channels", [None, 8])
def test_spatial_rescaler_matches_jax(out_channels):
    x = np.random.RandomState(2).rand(2, 18, 14, 3).astype(np.float32)
    jm = jenc.SpatialRescaler(n_stages=2, multiplier=0.5, out_channels=out_channels)
    m = penc.SpatialRescaler(n_stages=2, multiplier=0.5, in_channels=3,
                             out_channels=out_channels)
    params = _port(m, jm, jnp.asarray(x), 2)
    _close(m(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


CLIP_IMG = dict(image_size=28, patch_size=14, width=32, heads=2, layers=2, output_dim=16)


@pytest.mark.parametrize("pool", [True, False])
def test_clip_image_encoder_matches_jax(pool):
    x = np.random.RandomState(3).randn(2, 28, 28, 3).astype(np.float32)
    jm = jenc.CLIPImageEncoder(jenc.CLIPImageConfig(**CLIP_IMG))
    m = penc.CLIPImageEncoder(penc.CLIPImageConfig(**CLIP_IMG))
    params = _port(m, jm, jnp.asarray(x), 3)
    _close(m(torch.from_numpy(x), pool=pool), jm.apply(params, jnp.asarray(x), pool=pool))


def test_frozen_clip_image_embedder_matches_jax():
    """[-1, 1] images at 40 px: the preprocessing's bicubic resize to 28,
    the tower, the extra projection."""
    x = np.random.RandomState(4).uniform(-1, 1, (2, 40, 36, 3)).astype(np.float32)
    jm = jenc.FrozenClipImageEmbedder(jenc.CLIPImageConfig(**CLIP_IMG), project_dim=8)
    m = penc.FrozenClipImageEmbedder(penc.CLIPImageConfig(**CLIP_IMG), project_dim=8)
    params = _port(m, jm, jnp.asarray(x), 4)
    _close(m(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))
    _close(penc.clip_preprocess(torch.from_numpy(x), 28),
           jenc.clip_preprocess(jnp.asarray(x), 28))


def test_clip_image_state_dict_inverts_convert_clip_image():
    rng = np.random.default_rng(0)
    sd = {"visual.conv1.weight": rng.normal(size=(32, 3, 14, 14)),
          "visual.class_embedding": rng.normal(size=(32,)),
          "visual.positional_embedding": rng.normal(size=(5, 32)),
          "visual.ln_pre.weight": rng.normal(size=32), "visual.ln_pre.bias": rng.normal(size=32),
          "visual.ln_post.weight": rng.normal(size=32),
          "visual.ln_post.bias": rng.normal(size=32),
          "visual.proj": rng.normal(size=(32, 16))}
    for i in range(2):
        p = f"visual.transformer.resblocks.{i}"
        for k, shape in (("ln_1.weight", 32), ("ln_1.bias", 32), ("ln_2.weight", 32),
                         ("ln_2.bias", 32), ("attn.in_proj_weight", (96, 32)),
                         ("attn.in_proj_bias", 96), ("attn.out_proj.weight", (32, 32)),
                         ("attn.out_proj.bias", 32), ("mlp.c_fc.weight", (128, 32)),
                         ("mlp.c_fc.bias", 128), ("mlp.c_proj.weight", (32, 128)),
                         ("mlp.c_proj.bias", 32)):
            sd[f"{p}.{k}"] = rng.normal(size=shape)
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    back = from_jax.clip_image_state_dict(cc.convert_clip_image(sd, layers=2))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    m = penc.FrozenClipImageEmbedder(penc.CLIPImageConfig(**CLIP_IMG))
    m.load_state_dict(back)  # strict: the keys are the module's


# -- the classifier ----------------------------------------------------------


@pytest.fixture(scope="module")
def classifier_inputs():
    x = np.random.RandomState(0).standard_normal((2, 16, 16, 4)).astype(np.float32)
    return x, np.array([3, 77], np.int32)


@pytest.mark.parametrize("pool", ["attention", "adaptive", "spatial"])
def test_noisy_latent_classifier_matches_jax(classifier_inputs, pool):
    x, ts = classifier_inputs
    kw = dict(model_channels=32, num_classes=10, channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(2,), pool=pool)
    jm = jcls.NoisyLatentClassifier(jcls.ClassifierConfig(**kw))
    cfg = pcls.ClassifierConfig(**kw, image_size=16)
    m = pcls.NoisyLatentClassifier(cfg).eval()
    params = _drawn(jm, 5, jnp.asarray(x), jnp.asarray(ts))
    m.load_state_dict(from_jax.classifier_state_dict(params, cfg))
    want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(ts))
    got = m(torch.from_numpy(x), torch.from_numpy(ts).long())
    assert got.shape == (2, 10)
    _close(got, want)

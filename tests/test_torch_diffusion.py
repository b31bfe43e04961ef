"""Port sampler math (mgldvsr_tpu_torch.core.diffusion) against the JAX
package on the CPU, float32: the temporal warp loss in both modes and its
gradient, p_sample and sample_video with a toy denoiser and the JAX
draws injected as noise, and initial_latents.

Tolerances: the loss is a sum of means over a few hundred elements (1e-6);
its gradient and the sampler outputs go through the schedule's large
coefficients (x_T is ~sqrt(1/alphas_cumprod) times the noise at t=999), so
they are held to 1e-5 relative and 1e-5 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.core import diffusion as jd
from mgldvsr_tpu.core import schedules as js
from mgldvsr_tpu_torch.core import diffusion as td
from mgldvsr_tpu_torch.core import schedules as ts


def _inputs(seed=0, b=2, t=5, h=8, w=8, c=4):
    rs = np.random.RandomState(seed)
    lat = rs.randn(b * t, h, w, c).astype(np.float32)
    ff = (rs.randn(b, t - 1, h, w, 2) * 1.5).astype(np.float32)
    fb = (rs.randn(b, t - 1, h, w, 2) * 1.5).astype(np.float32)
    occ_f = (rs.rand(b, t - 1, h, w, 1) < 0.3).astype(np.float32)
    occ_b = (rs.rand(b, t - 1, h, w, 1) < 0.3).astype(np.float32)
    return lat, (ff, fb), (occ_f, occ_b)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return tuple(torch.from_numpy(a) for a in tree)


@pytest.mark.parametrize("mode", ["reference", "aligned"])
@pytest.mark.parametrize("t", [5, 3, 2])
def test_temporal_warp_loss_and_grad_match(mode, t):
    lat, flows, occs = _inputs(t=t)
    want, want_g = jax.value_and_grad(
        lambda l: jd.temporal_warp_loss(l, _j(flows), _j(occs), t, mode))(jnp.asarray(lat))
    lt = torch.from_numpy(lat).requires_grad_(True)
    got = td.temporal_warp_loss(lt, _t(flows), _t(occs), t, mode)
    (got_g,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


def test_adain_matches():
    rs = np.random.RandomState(1)
    c = rs.randn(3, 10, 12, 4).astype(np.float32)
    s = (rs.randn(3, 10, 12, 4) * 2 + 1).astype(np.float32)
    np.testing.assert_allclose(
        td.adaptive_instance_normalization(torch.from_numpy(c), torch.from_numpy(s)).numpy(),
        np.asarray(jd.adaptive_instance_normalization(jnp.asarray(c), jnp.asarray(s))),
        rtol=1e-5, atol=1e-5)


def _toy_denoisers():
    w = np.random.RandomState(2).randn(4, 4).astype(np.float32) * 0.3

    def jfn(x, t):
        return jnp.tanh(x @ jnp.asarray(w)) + jnp.sin(t.astype(jnp.float32) / 100)[:, None, None, None]

    def tfn(x, t):
        return torch.tanh(x @ torch.from_numpy(w)) + torch.sin(t.float() / 100)[:, None, None, None]

    return jfn, tfn


def _schedules(steps):
    return (js.respace_schedule(js.DiffusionSchedule.create(), steps),
            ts.respace_schedule(ts.DiffusionSchedule.create(device="cpu"), steps))


@pytest.mark.parametrize("guided", [True, False])
def test_p_sample_matches_with_injected_noise(guided):
    """The JAX draw for this key is fed to the port as ``noise``."""
    jsched, tsched = _schedules(10)
    jfn, tfn = _toy_denoisers()
    lat, flows, occs = _inputs(seed=3)
    cfg_kw = dict(num_frames=5, guidance_scale=-10.0, temperature=0.7)
    key = jax.random.PRNGKey(4)
    i = 6
    want = jd.p_sample(jsched, jfn, jnp.asarray(lat), jnp.int32(i), key,
                       jd.SamplerConfig(**cfg_kw), _j(flows) if guided else None,
                       _j(occs) if guided else None)
    noise = np.array(jax.random.normal(key, lat.shape, jnp.float32))
    got = td.p_sample(tsched, tfn, torch.from_numpy(lat), i, None, td.SamplerConfig(**cfg_kw),
                      _t(flows) if guided else None, _t(occs) if guided else None,
                      noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sample_video_matches_with_injected_noise():
    """Three guided steps over two windows, the JAX per-step draws (key
    split once per step, as its scan does) injected, then latent AdaIN."""
    jsched, tsched = _schedules(3)
    jfn, tfn = _toy_denoisers()
    lat, flows, occs = _inputs(seed=5)
    adain = np.random.RandomState(6).randn(*lat.shape).astype(np.float32)
    cfg_kw = dict(num_frames=5, guidance_scale=-10.0, temperature=1.0)
    key = jax.random.PRNGKey(7)
    want = jd.sample_video(jsched, jfn, jnp.asarray(lat), key, jd.SamplerConfig(**cfg_kw),
                           _j(flows), _j(occs), adain_fea=jnp.asarray(adain)).latents
    noises, k = [], key
    for _ in range(3):
        k, sub = jax.random.split(k)
        noises.append(np.asarray(jax.random.normal(sub, lat.shape, jnp.float32)))
    got = td.sample_video(tsched, tfn, torch.from_numpy(lat), None, td.SamplerConfig(**cfg_kw),
                          _t(flows), _t(occs), adain_fea=torch.from_numpy(adain),
                          noises=torch.from_numpy(np.stack(noises))).latents
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sample_video_start_T_and_deterministic():
    """start_T skips the steps above it; temperature 0 needs no generator
    and matches JAX's zero-scaled draws."""
    jsched, tsched = _schedules(10)
    jfn, tfn = _toy_denoisers()
    lat, flows, occs = _inputs(seed=8, b=1)
    cfg_kw = dict(num_frames=5, guidance_scale=-5.0, temperature=0.0)
    want = jd.sample_video(jsched, jfn, jnp.asarray(lat), jax.random.PRNGKey(0),
                           jd.SamplerConfig(**cfg_kw), _j(flows), _j(occs), start_T=500).latents
    got = td.sample_video(tsched, tfn, torch.from_numpy(lat), None, td.SamplerConfig(**cfg_kw),
                          _t(flows), _t(occs), start_T=500).latents
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_initial_latents_match():
    jb, tb = js.DiffusionSchedule.create(), ts.DiffusionSchedule.create(device="cpu")
    rs = np.random.RandomState(9)
    z, noise = (rs.randn(5, 8, 8, 4).astype(np.float32) for _ in range(2))
    want = jd.initial_latents(jb, jnp.asarray(z), jax.random.PRNGKey(0), noise=jnp.asarray(noise))
    got = td.initial_latents(tb, torch.from_numpy(z), None, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    drawn = td.initial_latents(tb, torch.from_numpy(z), torch.Generator().manual_seed(1))
    assert drawn.shape == z.shape and torch.isfinite(drawn).all()

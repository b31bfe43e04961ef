"""Port ops against the JAX package on the CPU, float32, same numpy inputs:
schedules, resize2d, flow_warp, resize_flow, occlusion, colour fix,
upscale_frames and the clip-flow helpers.

Tolerances: schedules are built by the same float64 numpy code and stored
as float32, so they agree to 1e-6; pointwise ops and small matrix
products agree to about 1e-6 relative, and 1e-5 leaves room for the other
summation order. The sinusoidal embedding takes cos/sin of arguments up to
999, where one float32 ulp is 6e-5, so it is held to 2e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.core import schedules as js
from mgldvsr_tpu_torch.core import schedules as ts


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("kind", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_schedules_equal(kind):
    np.testing.assert_array_equal(ts.make_beta_schedule(kind, 1000, 0.00085, 0.012),
                                  js.make_beta_schedule(kind, 1000, 0.00085, 0.012))


@pytest.mark.parametrize("counts", [[50], [10, 5], "ddim25", "20,10"])
def test_space_timesteps_equal(counts):
    assert ts.space_timesteps(1000, counts) == js.space_timesteps(1000, counts)


def test_schedule_and_respacing_match():
    jb = js.DiffusionSchedule.create(1000, "linear", 0.00085, 0.0120)
    tb = ts.DiffusionSchedule.create(1000, "linear", 0.00085, 0.0120)
    jr, tr = js.respace_schedule(jb, 50), ts.respace_schedule(tb, 50)
    for jsched, tsched in ((jb, tb), (jr, tr)):
        for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                     "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
                     "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                     "posterior_variance", "posterior_log_variance_clipped",
                     "posterior_mean_coef1", "posterior_mean_coef2", "lvlb_weights"):
            _close(getattr(tsched, name), getattr(jsched, name), atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(_np(tsched.timestep_map), np.asarray(jsched.timestep_map))
    assert int(tr.timestep_map[-1]) == 999 and tr.num_timesteps == 50


def test_pointwise_schedule_ops_match():
    jr = js.respace_schedule(js.DiffusionSchedule.create(), 50)
    tr = ts.respace_schedule(ts.DiffusionSchedule.create(), 50)
    rs = np.random.RandomState(0)
    x0, xt, eps = (rs.randn(4, 6, 6, 4).astype(np.float32) for _ in range(3))
    t = np.array([49, 20, 3, 0])
    jt, tt = jnp.asarray(t, jnp.int32), torch.from_numpy(t)
    _close(ts.q_sample(tr, torch.from_numpy(x0), tt, torch.from_numpy(eps)),
           js.q_sample(jr, jnp.asarray(x0), jt, jnp.asarray(eps)), atol=1e-6)
    _close(ts.predict_start_from_noise(tr, torch.from_numpy(xt), tt, torch.from_numpy(eps)),
           js.predict_start_from_noise(jr, jnp.asarray(xt), jt, jnp.asarray(eps)), atol=1e-5)
    for got, want in zip(ts.q_posterior(tr, torch.from_numpy(x0), torch.from_numpy(xt), tt),
                         js.q_posterior(jr, jnp.asarray(x0), jnp.asarray(xt), jt)):
        _close(got, want, atol=1e-6)
    _close(ts.extract(tr.betas, 7, 4), js.extract(jr.betas, 7, 4), atol=0, rtol=0)


def test_timestep_embedding_matches():
    t = np.array([0, 1, 17, 500, 999])
    for dim in (32, 33, 320):
        _close(ts.timestep_embedding(torch.from_numpy(t), dim),
               js.timestep_embedding(jnp.asarray(t), dim), atol=2e-4, rtol=0)


@pytest.mark.parametrize("method,size,align", [
    ("bicubic", (32, 44), False), ("bicubic", (5, 7), False), ("bilinear", (12, 9), False),
    ("bilinear", (16, 20), True), ("area", (4, 5), False), ("nearest", (13, 6), False)])
def test_resize2d_matches(method, size, align):
    from mgldvsr_tpu.ops.resize import resize2d as jresize
    from mgldvsr_tpu_torch.ops.resize import resize2d

    x = np.random.RandomState(1).rand(2, 8, 11, 3).astype(np.float32)
    _close(resize2d(torch.from_numpy(x), size, method, align),
           jresize(jnp.asarray(x), size, method, align))


def test_upscale_frames_matches():
    from mgldvsr_tpu.infer.pipeline import upscale_frames as jup
    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames

    x = np.random.RandomState(2).rand(3, 8, 8, 3).astype(np.float32)
    got = upscale_frames(torch.from_numpy(x), 4)
    assert got.shape == (3, 32, 32, 3)
    _close(got, jup(jnp.asarray(x), 4))


@pytest.mark.parametrize("mode,padding,mask", [
    ("bilinear", "zeros", False), ("bilinear", "zeros", True),
    ("bilinear", "border", False), ("nearest", "zeros", True), ("nearest", "border", False)])
def test_flow_warp_matches(mode, padding, mask):
    from mgldvsr_tpu.ops.warp import flow_warp as jwarp
    from mgldvsr_tpu_torch.ops.warp import flow_warp

    rs = np.random.RandomState(3)
    x = rs.randn(2, 9, 10, 3).astype(np.float32)
    flow = (rs.rand(2, 9, 10, 2) * 8 - 4).astype(np.float32)
    got = flow_warp(torch.from_numpy(x), torch.from_numpy(flow), mode, padding, mask)
    want = jwarp(jnp.asarray(x), jnp.asarray(flow), mode, padding, mask)
    if mask:
        _close(got[1], want[1], atol=0, rtol=0)
        got, want = got[0], want[0]
    _close(got, want)


@pytest.mark.parametrize("size_type,sizes", [("ratio", (0.125, 0.125)), ("shape", (5, 7))])
def test_resize_flow_matches(size_type, sizes):
    from mgldvsr_tpu.ops.warp import resize_flow as jrf
    from mgldvsr_tpu_torch.ops.warp import resize_flow

    flow = (np.random.RandomState(4).randn(2, 32, 24, 2) * 3).astype(np.float32)
    _close(resize_flow(torch.from_numpy(flow), size_type, sizes),
           jrf(jnp.asarray(flow), size_type, sizes))


def test_occlusion_check_matches():
    from mgldvsr_tpu.ops.occlusion import forward_backward_consistency_check as jcheck
    from mgldvsr_tpu_torch.ops.occlusion import forward_backward_consistency_check

    rs = np.random.RandomState(5)
    fwd = (rs.randn(3, 12, 12, 2) * 1.5).astype(np.float32)
    bwd = (-fwd + rs.randn(3, 12, 12, 2) * 0.4).astype(np.float32)
    got = forward_backward_consistency_check(torch.from_numpy(fwd), torch.from_numpy(bwd))
    want = jcheck(jnp.asarray(fwd), jnp.asarray(bwd))
    for g, w in zip(got, want):
        assert 0.05 < float(np.asarray(w).mean()) < 0.95  # both classes present
        _close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("kind", ["adain", "wavelet", "none"])
def test_colorfix_matches(kind):
    from mgldvsr_tpu.infer.colorfix import apply_colorfix as jfix
    from mgldvsr_tpu_torch.infer.colorfix import apply_colorfix

    rs = np.random.RandomState(6)
    out = (rs.rand(2, 40, 36, 3) * 2 - 1).astype(np.float32)
    ref = (rs.rand(2, 40, 36, 3) * 1.5 - 0.5).astype(np.float32)
    _close(apply_colorfix(torch.from_numpy(out), torch.from_numpy(ref), kind),
           jfix(jnp.asarray(out), jnp.asarray(ref), kind))


def test_clip_flow_helpers_match():
    """compute_clip_flows with a toy flownet, chunked pairs against the JAX
    lax.map chunking, latent-resolution resize and occlusion masks."""
    from mgldvsr_tpu.flow import compute as jc
    from mgldvsr_tpu.infer.pipeline import _chunked_pairs
    from mgldvsr_tpu_torch.flow import compute as tc

    rs = np.random.RandomState(7)
    frames = rs.rand(2, 4, 16, 16, 3).astype(np.float32)

    def jnet(a, b):
        return jnp.concatenate([a[..., :1] - b[..., 1:2], a[..., 2:] * b[..., :1]], -1) * 4

    def tnet(a, b):
        return torch.cat([a[..., :1] - b[..., 1:2], a[..., 2:] * b[..., :1]], -1) * 4

    jff, jfb = jc.compute_clip_flows(_chunked_pairs(jnet, 4), jnp.asarray(frames))
    tff, tfb = tc.compute_clip_flows(tc.chunked_pairs(tnet, 4), torch.from_numpy(frames))
    _close(tff, jff)
    _close(tfb, jfb)
    jff, jfb = jc.flows_to_latent_res(jff), jc.flows_to_latent_res(jfb)
    tff, tfb = tc.flows_to_latent_res(tff), tc.flows_to_latent_res(tfb)
    _close(tff, jff)
    for g, w in zip(tc.compute_occlusion_masks(tff, tfb), jc.compute_occlusion_masks(jff, jfb)):
        _close(g, w, atol=0, rtol=0)

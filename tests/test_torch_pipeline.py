"""The slice end to end: the port's MGLDVSRPipeline against the JAX
package's at tiny widths on the CPU, float32, with the same weights (JAX
init -> io.from_jax -> port) and the same frames.

RAFT's last flow-head conv is scaled by 1e-2 on both sides: random RAFT
weights otherwise predict large flows that disagree between directions,
every pixel is marked occluded and the guidance term is zero; small flows
keep it active, so the comparison covers the guided sampler.

Tolerances: the deterministic restore runs ~150 float32 layers, two
guided steps and a decode on each side, summing in other orders; 2e-4 on
the [0,1] output is a few times the largest difference observed. Stage
outputs (latents, flows) are held to 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.infer.pipeline import MGLDVSRPipeline as JaxPipeline
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
from mgldvsr_tpu_torch.io import from_jax
from tests.test_pipeline import tiny_config
from tests.test_torch_models import jax_pipeline_and_params, numpy_tree, port_config


def _frames(seed, n=5, size=64):
    """A smooth pattern moving 1 px per frame, plus a little noise, [0,1]."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size + n, 0:size + n].astype(np.float32) / size
    pat = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (rs.uniform(1, 3) * xx + rs.uniform(1, 3) * yy))
                    for _ in range(3)], -1)
    clip = np.stack([pat[f:f + size, f:f + size] for f in range(n)])
    return np.clip(clip + 0.03 * rs.rand(*clip.shape), 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def pipes():
    jcfg = tiny_config(num_frames=5, ddpm_steps=2)
    jpipe, params = jax_pipeline_and_params(jcfg, size=64)
    params = numpy_tree(params)
    params["raft"]["params"]["update_scan"]["update_block"]["flow_head_conv2"]["kernel"] *= 1e-2
    cfg = port_config(jcfg)
    pipe = MGLDVSRPipeline(cfg, device="cpu")
    for name, sd in from_jax.pipeline_state_dicts(params, cfg).items():
        pipe.towers()[name].load_state_dict(sd, strict=True)
    return jpipe, jax.tree_util.tree_map(jnp.asarray, params), pipe


@pytest.mark.parametrize("fused", ["0", "1"])
def test_restore_segment_deterministic_matches_jax(pipes, monkeypatch, fused):
    """Both configurations: MGLD_FUSED_GN_CONV off, and on on both sides (the
    JAX package reads it while tracing, so it gets a fresh pipeline; the
    parameters and the port's loaded state dicts are the same)."""
    jpipe, params, pipe = pipes
    monkeypatch.setenv("MGLD_FUSED_GN_CONV", fused)
    if fused == "1":
        jpipe = JaxPipeline(jpipe.cfg)
    frames = _frames(0)
    want = jax.jit(lambda p, f: jpipe.restore_segment(
        p, f, jax.random.PRNGKey(0), deterministic=True))(params, jnp.asarray(frames))
    got = pipe.restore_segment(torch.from_numpy(frames), deterministic=True)
    assert got.shape == (5, 64, 64, 3)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_stages_match_jax(pipes):
    """encode (posterior mode), the empty-prompt context, flows and masks
    (guidance active: some pixels unoccluded), and a window-chunked decode."""
    jpipe, params, pipe = pipes
    frames = np.concatenate([_frames(1), _frames(2)])  # two windows
    jlat, jfea = jax.jit(lambda p, f: jpipe.encode(p, f, None, sample_posterior=False))(
        params, jnp.asarray(frames * 2 - 1))
    lat, fea = pipe.encode(torch.from_numpy(frames * 2 - 1), sample_posterior=False)
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), atol=1e-4, rtol=0)

    np.testing.assert_allclose(pipe.embed_empty_prompt(10).numpy(),
                               np.asarray(jpipe.embed_empty_prompt(params, 10)), atol=1e-4)

    (jff, jfb), (jmf, jmb) = jax.jit(jpipe.compute_flows)(params, jnp.asarray(frames))
    (ff, fb), (mf, mb) = pipe.compute_flows(torch.from_numpy(frames))
    assert ff.shape == (2, 4, 8, 8, 2)
    for g, w in ((ff, jff), (fb, jfb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    for g, w in ((mf, jmf), (mb, jmb)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(mf.mean()) < 1.0

    want = jax.jit(lambda p, z, f: jpipe.decode(p, z, f, 0.5))(params, jlat, jfea)
    for cw in (None, 1):
        got = pipe.decode(lat, fea, 0.5, chunk_windows=cw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_flow_chunk_pairs_zero_or_none_is_one_call(pipes, monkeypatch):
    """``flow_chunk_pairs`` 0 and None run RAFT once over all 8 pairs (both
    directions of 4), 2 in four calls of 2, with the same flows and masks,
    contiguous as the guidance kernels take them (float32, 1e-6: the convs
    see other batch sizes); a negative count raises."""
    _, _, pipe = pipes
    frames = torch.from_numpy(_frames(4))
    batches = []
    hook = pipe.raft.register_forward_pre_hook(lambda mod, args: batches.append(args[0].shape[0]))
    try:
        out = {}
        for chunk in (0, None, 2, -1):
            monkeypatch.setattr(pipe, "cfg", dataclasses.replace(pipe.cfg, flow_chunk_pairs=chunk))
            batches.clear()
            if chunk == -1:
                with pytest.raises(ValueError, match="flow chunk"):
                    pipe.compute_flows(frames)
                continue
            out[chunk] = pipe.compute_flows(frames)
            assert batches == ([2] * 4 if chunk else [8])
    finally:
        hook.remove()
    for chunk in (None, 2):
        for got, want in zip((*out[chunk][0], *out[chunk][1]), (*out[0][0], *out[0][1])):
            assert got.is_contiguous() and want.is_contiguous()
            torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_restore_segment_sampling_needs_a_generator(pipes):
    _, _, pipe = pipes
    frames = torch.from_numpy(_frames(3))
    with pytest.raises(ValueError):
        pipe.restore_segment(frames)
    stages = {}
    out = pipe.restore_segment(frames, torch.Generator().manual_seed(0), stage_seconds=stages)
    assert out.shape == (5, 64, 64, 3) and torch.isfinite(out).all()
    assert list(stages) == ["encode", "clip", "flows", "sampler", "decode"]


def test_default_device_is_the_card_and_is_required():
    """No device argument means the GPU; where there is none the constructor
    raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        MGLDVSRPipeline(port_config(tiny_config(num_frames=5, ddpm_steps=2)))

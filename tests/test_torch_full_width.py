"""The port against the JAX package at the shipped SD2.1 widths on the CPU,
float32 (JAX at 'highest' matmul precision, ``tests/conftest.py``): the
four towers one at a time and a 2-step deterministic restore at 256 px.
Marked ``slow``: about 1.45 G parameters live on each side.

Weights: ``PipelineConfig()``'s towers (UNet 320/640/1280/1280 with its
8^2 temporal middle block, struct-cond 256/512 with 4 heads, the video VAE
at ch_mult (1,2,4,4) with fusion, OpenCLIP's 24 layers at width 1024
(penultimate), RAFT at 10 iterations), 5 frames, the JAX fast init
(``init_params``) carried over by ``io.from_jax``. RAFT's last flow-head
conv is scaled by 1e-2 on both sides, as ``chip_smoke.calm_raft`` does:
seeded RAFT otherwise marks every pixel occluded and the guidance term is
zero. The port's towers are emptied onto the meta device before the JAX
tree exists and take the converted tensors by ``assign``, so the two
sides' weights are the only copies held (about 12 GB in all).

Tolerances on max |Δ|, each a few times the largest difference observed
and far below the activations' scale (the rule of
``tests/test_torch_models.py``); the observed values, from one run of this
file on a CPU machine, and the outputs' largest |value| are in brackets:

- struct-cond features 1e-4 [2.0e-5; ~10];
- UNet eps 5e-5 [1.0e-5 at t=999, 8.0e-6 at t=500; 2.7];
- VAE moments 5e-5 [8.9e-6; 2.7], LQ features 1e-4 [1.9e-5; 12]; the
  decode with fusion at dec_w 1.0, 5e-5 [7.7e-6; 2.9];
- CLIP 3e-5 [5.2e-6; 4.7]; RAFT's flow 3e-5 [6.6e-6; 0.95 px];
- the 2-step restore 5e-3 [1.77e-3, mean 3.3e-6, on [0, 1] frames]: 25
  times the tiny restore's 2e-4. Stage by stage the two sides agree to
  float32 rounding (the posterior mode to 1.4e-6, the flows to 6.7e-7, the
  occlusion masks exactly, the decode of the same latents to 6.2e-6). The
  sampler's latents differ by 3.3e-4 with guidance and without, on latents
  of ~60: with untrained weights the UNet predicts eps ~2.7 at t=999, where
  the x0 estimate divides by sqrt(alpha_bar) = 0.068, so each step scales
  eps's float32 rounding (~1e-5) by ~15, and the decoder then reads
  latents / 0.18215 of ~330. Not a fault of either side. On the card
  (chip_smoke phase 13 (a)) one guidance residual within rounding of 0
  took the other sign than on the CPU, and that one flip moved a patch of
  the frames by 7.1e-3; phase 13 replays the card's signs on the CPU to
  compare the rest. The comparison here is not instrumented so: a flip
  between the port and JAX would exceed 5e-3 too.

bf16 drift: the port's own 2-step restore with bf16 towers (fp32 RAFT, the
card's dtypes) against its fp32 restore [max |Δ| 0.164, mean 9.3e-3, PSNR
37.6 dB, on [0, 1] frames], bounded at 0.5 max and 0.03 mean. The same
x0 amplification turns bf16's ~4e-3 relative rounding of eps into
latent differences of ~0.2. It sets the card's bf16-against-fp32 bound
(PERF.md §6, chip_smoke phase 13).

Cost, run alone on an 8-core CPU machine: 285 s of wall and a peak RSS
of 14.78 GiB (383 s and 14.97 GiB in a run that shared the machine).

Run alone: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_full_width.py
-m slow -s -p no:cacheprovider`` (the ``-s`` shows each comparison's max
and mean |Δ|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.infer.pipeline import MGLDVSRPipeline as JaxPipeline
from mgldvsr_tpu.infer.pipeline import PipelineConfig as JaxPipelineConfig
from mgldvsr_tpu.models.cliptext import empty_prompt_tokens as jax_tokens
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
from mgldvsr_tpu_torch.io import from_jax
from mgldvsr_tpu_torch.models.cliptext import empty_prompt_tokens
from tests.test_torch_models import nchw, port_config, t2n, to_nhwc
from tests.test_torch_pipeline import _frames

pytestmark = pytest.mark.slow

CONVERTERS = {"unet": from_jax.unet_state_dict, "structcond": from_jax.structcond_state_dict,
              "vae": from_jax.vae_state_dict, "clip": from_jax.clip_state_dict,
              "raft": from_jax.raft_state_dict}
SIZE = 256


def report(name, got, want, tol):
    """Print max and mean |Δ| beside the reference's scale, then hold max
    |Δ| to ``tol``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    print(f"\n{name}: max|d| {d.max():.3e} mean|d| {d.mean():.3e} "
          f"max|want| {np.abs(want).max():.3e}", flush=True)
    assert d.max() <= tol, (name, d.max())


def load_port(pipe, cfg, views):
    """Every tower of ``pipe`` (emptied onto meta) takes the converted JAX
    tensors as its own."""
    for name, convert in CONVERTERS.items():
        pipe.towers()[name].load_state_dict(convert(views[name], getattr(cfg, name)),
                                            strict=True, assign=True)


def empty_port(cfg):
    pipe = MGLDVSRPipeline(cfg, device="cpu")
    for tower in pipe.towers().values():
        tower.to_empty(device="meta")
    return pipe


@pytest.fixture(scope="module")
def full():
    jcfg = JaxPipelineConfig(ddpm_steps=2)
    assert (jcfg.unet.model_channels, jcfg.clip.layers, jcfg.vae.ch, jcfg.raft.iters,
            jcfg.num_frames, jcfg.vae.enable_fusion) == (320, 24, 128, 10, 5, True)
    cfg = port_config(jcfg)
    pipe = empty_port(cfg)
    jpipe = JaxPipeline(jcfg)
    params = jpipe.init_params(jax.random.PRNGKey(0), 64, 64)
    head = params["raft"]["params"]["update_scan"]["update_block"]["flow_head_conv2"]
    head["kernel"] = head["kernel"] * 1e-2
    views = jax.tree_util.tree_map(np.asarray, params)  # the JAX buffers, not copies
    load_port(pipe, cfg, views)
    ctx = np.asarray(jax.jit(jpipe.clip.apply)(params["clip"], jax_tokens(5)))
    state = {"jcfg": jcfg, "cfg": cfg, "jpipe": jpipe, "params": params, "views": views,
             "pipe": pipe, "ctx": ctx}
    del pipe  # the dict holds the only reference: the bf16 test frees it
    yield state


def test_structcond_and_unet_match_jax(full):
    """Latents 32^2 (256 px), 5 frames, t in {999, 500}, the empty-prompt
    context; the UNet gets the JAX struct-cond features on both sides."""
    jpipe, params, pipe = full["jpipe"], full["params"], full["pipe"]
    rs = np.random.RandomState(0)
    z_lq = rs.randn(5, 32, 32, 4).astype(np.float32)
    x = rs.randn(5, 32, 32, 4).astype(np.float32)
    sc_fn = jax.jit(jpipe.structcond.apply)
    unet_fn = jax.jit(jpipe.unet.apply)
    for t in (999, 500):
        tt = np.full((5,), t, np.int32)
        want_sc = sc_fn(params["structcond"], jnp.asarray(z_lq), jnp.asarray(tt))
        with torch.no_grad():
            got_sc = pipe.structcond(nchw(z_lq), torch.from_numpy(tt).long())
        assert sorted(got_sc) == sorted(want_sc) == ["16", "32", "4", "8"]
        for k in want_sc:
            report(f"structcond t={t} [{k}]", to_nhwc(got_sc[k]), want_sc[k], 1e-4)
        sc = {k: np.asarray(v) for k, v in want_sc.items()}
        want = unet_fn(params["unet"], jnp.asarray(x), jnp.asarray(tt), jnp.asarray(full["ctx"]),
                       {k: jnp.asarray(v) for k, v in sc.items()})
        with torch.no_grad():
            got = pipe.unet(nchw(x), torch.from_numpy(tt).long(), torch.from_numpy(full["ctx"]),
                            {k: nchw(v) for k, v in sc.items()})
        report(f"unet t={t}", to_nhwc(got), want, 5e-5)


def test_vae_matches_jax(full):
    """Encode with features and decode with fusion at dec_w 1.0, 256^2."""
    jpipe, params, pipe = full["jpipe"], full["params"], full["pipe"]
    x = _frames(1, size=SIZE) * 2 - 1
    moments, fea = jax.jit(lambda p, f: jpipe.vae.apply(p, f, method="encode"))(
        params["vae"], jnp.asarray(x))
    with torch.no_grad():
        got_m, got_fea = pipe.vae.encode(nchw(x))
    report("vae moments", to_nhwc(got_m), moments, 5e-5)
    assert len(got_fea) == len(fea) == 2
    for i, (g, w) in enumerate(zip(got_fea, fea)):
        report(f"vae feature {i}", to_nhwc(g), w, 1e-4)
    z = np.random.RandomState(2).randn(5, SIZE // 8, SIZE // 8, 4).astype(np.float32)
    want = jax.jit(lambda p, z_, f: jpipe.vae.apply(p, z_, f, 1.0, method="decode"))(
        params["vae"], jnp.asarray(z), fea)
    with torch.no_grad():
        got = pipe.vae.decode(nchw(z), [nchw(np.asarray(f)) for f in fea], 1.0)
    report("vae decode", to_nhwc(got), want, 5e-5)


def test_clip_matches_jax(full):
    """The empty prompt through all 23 blocks of the penultimate tower."""
    with torch.no_grad():
        got = full["pipe"].clip(empty_prompt_tokens(5, device="cpu"))
    report("clip", t2n(got), full["ctx"], 3e-5)


def test_raft_matches_jax(full):
    """Four pairs at 256^2, 10 iterations."""
    jpipe, params, pipe = full["jpipe"], full["params"], full["pipe"]
    f = _frames(3, size=SIZE)
    a, b = f[:4], f[1:]
    want = jax.jit(jpipe.raft.apply)(params["raft"], jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = pipe.raft(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (4, SIZE, SIZE, 2)
    report("raft flow", t2n(got), want, 3e-5)


@pytest.fixture(scope="module")
def restores(full):
    """The deterministic 2-step restore at 256 px: JAX and the port."""
    jpipe, params, pipe = full["jpipe"], full["params"], full["pipe"]
    frames = _frames(0, size=SIZE)
    want = jax.jit(lambda p, f: jpipe.restore_segment(
        p, f, jax.random.PRNGKey(0), deterministic=True))(params, jnp.asarray(frames))
    got = pipe.restore_segment(torch.from_numpy(frames), deterministic=True)
    return frames, np.asarray(want), got.numpy()


def test_restore_matches_jax(full, restores):
    _, want, got = restores
    assert got.shape == (5, SIZE, SIZE, 3)
    assert got.min() >= 0.0 and got.max() <= 1.0
    report("restore (2 steps, 256 px)", got, want, 5e-3)


def test_bf16_drift_of_the_port(full, restores):
    """The port with bf16 towers and fp32 RAFT (the card's dtypes) against
    its own fp32 restore: the drift that bounds bf16 against fp32 on the
    card."""
    frames, _, fp32 = restores
    del full["pipe"]
    cfg = full["cfg"]
    bf = {n: dataclasses.replace(getattr(cfg, n), dtype=torch.bfloat16)
          for n in ("unet", "structcond", "vae", "clip")}
    cfg16 = dataclasses.replace(cfg, **bf)
    pipe = empty_port(cfg16)
    load_port(pipe, cfg16, full["views"])
    pipe.cast_to_compute_dtypes()
    got = pipe.restore_segment(torch.from_numpy(frames), deterministic=True).numpy()
    d = np.abs(got - fp32)
    print(f"\nbf16 drift (2 steps, 256 px): max|d| {d.max():.3e} mean|d| {d.mean():.3e} "
          f"psnr {10 * np.log10(1.0 / np.mean(d ** 2)):.2f} dB", flush=True)
    assert np.isfinite(got).all() and d.max() <= 0.5 and d.mean() <= 0.03

"""The tile and latent restore paths of the port against the JAX package's,
on the CPU at tiny widths, float32, with the same weights (JAX init ->
io.from_jax -> port) and the same frames.

RAFT's last flow-head conv is scaled by 1e-2 on both sides, as in
``test_torch_pipeline.py``, so the guidance term is active. Tolerances:
the grid arithmetic (offsets, weights, patch positions) is exact; a toy
denoiser stitched by both sides agrees to 1e-6 (float32 sums of the same
terms in the same order, ``jit`` may fuse them differently); the
deterministic restores to 2e-4 on [0,1], the tolerance of the fixed-path
test, since they run the same towers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.infer import canvas as jcanvas
from mgldvsr_tpu_torch.core.diffusion import SamplerConfig, p_sample, window_tiled_randn
from mgldvsr_tpu_torch.core.schedules import DiffusionSchedule, respace_schedule
from mgldvsr_tpu_torch.infer import canvas
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, reflect_pad
from mgldvsr_tpu_torch.io import from_jax
from tests.test_pipeline import tiny_config
from tests.test_torch_models import jax_pipeline_and_params, numpy_tree, port_config

TILE = dict(tile=4, tile_overlap=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast as many, and the suite
    runs several workers on one machine, whose threads would contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def _clip(seed, h, w, n=5):
    """A smooth pattern moving 1 px per frame plus a little noise, [0,1]."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h + n, 0:w + n].astype(np.float32) / max(h, w)
    pat = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (rs.uniform(1, 3) * xx + rs.uniform(1, 3) * yy))
                    for _ in range(3)], -1)
    clip = np.stack([pat[f:f + h, f:f + w] for f in range(n)])
    return np.clip(clip + 0.03 * rs.rand(*clip.shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("case", [
    ("offsets", (64, 64, 32)), ("offsets", (96, 64, 32)), ("offsets", (128, 64, 32)),
    ("offsets", (48, 64, 32)), ("offsets", (92, 64, 32)), ("offsets", (120, 64, 32)),
    ("offsets", (1280, 960, 210)), ("offsets", (736, 512, 64)), ("offsets", (160, 64, 8)),
    ("offsets", (13, 4, 2)), ("weights", (64, 64)), ("weights", (4, 4)), ("weights", (5, 7)),
    ("weights", (64, 28)), ("spliter", ((5, 96, 64, 3), 64, 48)),
    ("spliter", ((5, 736, 1280, 3), 960, 750)), ("spliter", ((5, 736, 1280, 3), 512, 448)),
    ("spliter", ((4, 92, 160, 2), 64, 56)), ("spliter", ((2, 100, 70, 3), 64, 48)),
    ("spliter", ((1, 30, 20, 3), 64, 48))])
def test_grid_matches_jax(case):
    """Tile offsets, stitching weights and patch positions equal the JAX
    package's exactly, at the tile path's real and tiny geometries."""
    kind, args = case
    if kind == "offsets":
        assert canvas.tile_offsets(*args) == jcanvas.tile_offsets(*args)
    elif kind == "weights":
        np.testing.assert_array_equal(canvas.gaussian_tile_weights(*args),
                                      jcanvas.gaussian_tile_weights(*args))
    else:
        got, want = canvas.ImageSpliter(*args), jcanvas.ImageSpliter(*args)
        assert got.positions == want.positions
        assert (got.pch_size_h, got.pch_size_w) == (want.pch_size_h, want.pch_size_w)


def test_spliter_split_and_gather_match_jax():
    frames = np.random.RandomState(0).rand(2, 100, 70, 3).astype(np.float32)
    got, want = canvas.ImageSpliter(frames.shape, 64, 48), jcanvas.ImageSpliter(frames.shape, 64, 48)
    gp = [p for p, _ in got.split(torch.from_numpy(frames))]
    wp = [np.asarray(p) for p, _ in want.split(jnp.asarray(frames))]
    for g, w in zip(gp, wp):
        np.testing.assert_array_equal(g.numpy(), w)
    scaled = [p * (i + 1) for i, p in enumerate(gp)]
    np.testing.assert_allclose(got.gather(scaled).numpy(),
                               want.gather([s.numpy() for s in scaled]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("batch_tiles", [1, 3, 4])
def test_tiled_denoise_matches_jax(batch_tiles):
    """A toy denoiser whose eps depends non-linearly on the tile, its
    struct-cond features, the timestep and the context: the stitched eps
    over a 12x10 canvas of 4-tiles (12 tiles, chunks of 1, 3 or 4, the last
    one short on the port's side) equals the JAX package's within 1e-6."""
    rs = np.random.RandomState(1)
    x = rs.randn(10, 12, 10, 4).astype(np.float32)
    struct = rs.randn(10, 12, 10, 4).astype(np.float32)
    ctx = rs.randn(10, 3, 8).astype(np.float32)
    t = np.arange(10, dtype=np.int32) * 7

    def build(lib, mk, x, struct, ctx, t):
        f32 = (lambda a: a.astype(jnp.float32)) if lib is jnp else (lambda a: a.float())

        def sc(s, tt):
            return lib.tanh(s * 0.7 + f32(tt)[:, None, None, None] * 1e-2)

        def unet(xx, tt, c, s_cond):
            return lib.sin(xx * 1.3 + s_cond) + c.mean((1, 2))[:, None, None, None]

        return mk(sc, unet, struct, ctx, tile=4, overlap=2, batch_tiles=batch_tiles)(x, t)

    want = build(jnp, jcanvas.make_tiled_denoise_fn, jnp.asarray(x), jnp.asarray(struct),
                 jnp.asarray(ctx), jnp.asarray(t))
    got = build(torch, canvas.make_tiled_denoise_fn, torch.from_numpy(x),
                torch.from_numpy(struct), torch.from_numpy(ctx), torch.from_numpy(t))
    assert got.shape == (10, 12, 10, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_window_tiled_noise_is_the_solo_draw():
    """K windows stacked on the frames axis each get the draw a solo call
    gets with the generator in the same state, in p_sample as in the
    helper; without the option the windows differ."""
    sched = respace_schedule(DiffusionSchedule.create(
        timesteps=1000, beta_schedule="linear", linear_start=0.00085, linear_end=0.0120,
        device="cpu"), 4)
    x1 = torch.randn(5, 6, 6, 4, generator=torch.Generator().manual_seed(0))
    x3 = x1.repeat(3, 1, 1, 1)
    cfg = SamplerConfig(num_frames=5, noise_window_tile=True)

    def denoise(x, t):
        return x * 0.1

    solo = p_sample(sched, denoise, x1, 2, torch.Generator().manual_seed(7), cfg)
    stacked = p_sample(sched, denoise, x3, 2, torch.Generator().manual_seed(7), cfg)
    for k in range(3):
        torch.testing.assert_close(stacked[5 * k:5 * k + 5], solo, atol=0, rtol=0)
    noise = window_tiled_randn(x3, 5, torch.Generator().manual_seed(7))
    torch.testing.assert_close(noise[:5], torch.randn(5, 6, 6, 4, generator=torch.Generator()
                                                      .manual_seed(7)), atol=0, rtol=0)
    plain = p_sample(sched, denoise, x3, 2, torch.Generator().manual_seed(7),
                     SamplerConfig(num_frames=5))
    assert not torch.equal(plain[:5], plain[5:10])


def test_reflect_pad_is_numpy_reflect():
    x = torch.arange(5 * 7 * 3 * 2, dtype=torch.float32).reshape(5, 7, 3, 2)
    for ph, pw in ((0, 0), (3, 2), (6, 5), (9, 1)):
        want = np.pad(x.numpy(), ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
        np.testing.assert_array_equal(reflect_pad(x, ph, pw).numpy(), want)


def test_restore_segment_canvas_matches_jax(pipes):
    """A 32x64 segment (4x8 latents, six 4-latent tiles in chunks of 4 and
    2), guidance on, deterministic; and the unclamped [-1,1] output with the
    final latents."""
    jpipe, params, pipe = pipes
    frames = _clip(2, 32, 64)
    want, wlat = jax.jit(lambda p, f: jpipe.restore_segment_canvas(
        p, f, jax.random.PRNGKey(0), batch_tiles=4, deterministic=True, clip01=False,
        return_latents=True, **TILE))(params, jnp.asarray(frames))
    got, lat = pipe.restore_segment_canvas(torch.from_numpy(frames), batch_tiles=4,
                                           deterministic=True, clip01=False,
                                           return_latents=True, **TILE)
    assert got.shape == (5, 32, 64, 3) and lat.shape == (5, 4, 8, 4)
    # the latents reach |10| after two steps of random weights: 1e-4 of that
    np.testing.assert_allclose(lat.numpy(), np.asarray(wlat), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(wlat)).max()))
    # [-1,1] here: 4e-4 is the 2e-4 of the [0,1] outputs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=4e-4, rtol=0)
    clipped = pipe.restore_segment_canvas(torch.from_numpy(frames), deterministic=True, **TILE)
    np.testing.assert_allclose(clipped.numpy(), np.clip((np.asarray(want) + 1) / 2, 0, 1),
                               atol=2e-4, rtol=0)


@pytest.mark.parametrize("patch_batch", [1, 2])
def test_restore_video_matches_jax(pipes, patch_batch):
    """The full tile protocol on the 13x11 awkward clip: upscale by 64/11 to
    75x64, reflect-pad to 96x64, flows once at 0.25, two 64px patches (stride
    48) of nine 4-latent tiles each, the gather, the padded-frame downscale
    to 66x44; guidance on, deterministic, one patch a group or both in one."""
    jpipe, params, pipe = pipes
    frames = _clip(3, 13, 11)
    kw = dict(pch_size=64, pch_stride=48, min_side=64, deterministic=True, **TILE)
    want = np.asarray(jpipe.restore_video(params, jnp.asarray(frames), jax.random.PRNGKey(0),
                                          **kw))
    stages = {}
    got = pipe.restore_video(torch.from_numpy(frames), patch_batch=patch_batch,
                             stage_seconds=stages, **kw)
    assert got.shape == (5, 66, 44, 3) == want.shape
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    assert list(stages) == ["upscale", "flows", "patches", "gather"]
    # 2e-4 a patch, as the fixed path, through the bicubic 96x64 -> 66x44
    # downscale, whose rows sum to 1.375 in absolute value on each axis: a
    # difference can grow by up to 1.375^2 = 1.89 there
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * 1.375 ** 2, rtol=0)


def test_restore_video_progress_lines_match_jax(pipes, monkeypatch, capsys):
    """``MGLD_PROGRESS`` set: the port prints the JAX package's stage lines
    (``[restore_video] <stage> <s>s``), the same stages in the same order,
    with its own seconds; without guidance no ``flows`` line; unset,
    nothing."""
    import re

    jpipe, params, pipe = pipes
    frames = _clip(3, 13, 11)
    kw = dict(pch_size=64, pch_stride=48, min_side=64, deterministic=True, **TILE)
    monkeypatch.setenv("MGLD_PROGRESS", "1")
    jpipe.restore_video(params, jnp.asarray(frames), jax.random.PRNGKey(0), **kw)

    def stages(out):
        return [re.sub(r"\d+\.\d\ds", "<s>", line) for line in out.splitlines()]

    want = stages(capsys.readouterr().out)
    assert want == ["[restore_video] pre-upscale+pad <s>", "[restore_video] flows <s>",
                    "[restore_video] patch loop (2) + device gather (drain <s>) <s>"]
    pipe.restore_video(torch.from_numpy(frames), **kw)
    assert stages(capsys.readouterr().out) == want
    pipe.restore_video(torch.from_numpy(frames), use_guidance=False, **kw)
    assert stages(capsys.readouterr().out) == [want[0], want[2]]
    monkeypatch.delenv("MGLD_PROGRESS")
    pipe.restore_video(torch.from_numpy(frames), **kw)
    assert capsys.readouterr().out == ""


def test_restore_with_latents_matches_jax(pipes, monkeypatch):
    """The w_latent protocol (flows at full resolution, the swapped masks,
    guidance -1.0). The JAX function always samples, so its gaussian draws
    are made zeros here, which is what ``deterministic=True`` does on the
    port's side."""
    jpipe, params, pipe = pipes
    frames = _clip(4, 32, 32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    want, wlat = jax.jit(lambda p, f: jpipe.restore_with_latents(
        p, f, jax.random.PRNGKey(0)))(params, jnp.asarray(frames))
    got, lat = pipe.restore_with_latents(torch.from_numpy(frames), deterministic=True)
    assert got.shape == (5, 32, 32, 3) and lat.shape == (5, 4, 4, 4)
    np.testing.assert_allclose(lat.numpy(), np.asarray(wlat), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(wlat)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_auto_geometry_and_patch_batch(pipes):
    """``pch_size=0`` resolves to one canvas tile a patch (32 px at tile 4)
    with stride 24, also when the stride given is stale; and two patches a
    group (the second group padded) give the frames of one a group at
    temperature 1 from one seed, because every group restarts the generator
    and draws per window (1e-4: the towers see batches of 5 and 10 frames,
    summed in other orders). The 8x14 clip is worked at 32x56, padded to
    32x64: three patches."""
    _, _, pipe = pipes
    frames = torch.from_numpy(_clip(5, 8, 14))
    kw = dict(min_side=32, **TILE)

    def run(patch_batch=1, **geometry):
        return pipe.restore_video(frames, torch.Generator().manual_seed(11),
                                  patch_batch=patch_batch, **geometry, **kw)

    auto = run(pch_size=0, pch_stride=0)
    torch.testing.assert_close(auto, run(pch_size=32, pch_stride=24), atol=0, rtol=0)
    torch.testing.assert_close(auto, run(pch_size=0, pch_stride=750), atol=0, rtol=0)
    batched = run(patch_batch=2, pch_size=0, pch_stride=0)
    torch.testing.assert_close(batched, auto, atol=1e-4, rtol=0)
    other_seed = pipe.restore_video(frames, torch.Generator().manual_seed(12), pch_size=0,
                                    pch_stride=0, patch_batch=1, **kw)
    assert float((other_seed - auto).abs().max()) > 1e-3
    assert pipe.patch_batch_envelope(512, 512) == 1


@pytest.mark.parametrize("free_gib, want", [(40, ((10, 4), (5, 2))), (20, ((5, 2), (2, 1))),
                                            (10, ((2, 1), (1, 1))), (1, ((1, 1), (1, 1)))])
def test_patch_batch_envelope(monkeypatch, free_gib, want):
    """On the card: 0.8 of the free bytes (CUDA's and the caching
    allocator's unused ones) over the measured bytes a patch pixel, at least
    1, for 512x512 and 736x960 patches; float32 towers take twice the bytes
    of bf16 ones; other widths or frame counts, and the CPU, take 1."""
    import dataclasses
    import types

    from mgldvsr_tpu_torch.infer import pipeline as pipeline_mod

    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (free_gib * 2 ** 30, 0))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 2 ** 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 2 ** 29)
    f32 = pipeline_mod.PipelineConfig()
    bf16 = dataclasses.replace(f32, **{name: dataclasses.replace(getattr(f32, name),
                                                                 dtype=torch.bfloat16)
                                       for name in ("unet", "structcond", "vae", "clip")})
    for cfg, expected in zip((bf16, f32), want):
        fake = types.SimpleNamespace(device=torch.device("cuda"), cfg=cfg)
        got = tuple(MGLDVSRPipeline.patch_batch_envelope(fake, ph, pw)
                    for ph, pw in ((512, 512), (736, 960)))
        assert got == expected
    for other in (dataclasses.replace(bf16, num_frames=7),
                  dataclasses.replace(bf16, vae=dataclasses.replace(bf16.vae, ch=64))):
        fake = types.SimpleNamespace(device=torch.device("cuda"), cfg=other)
        assert MGLDVSRPipeline.patch_batch_envelope(fake, 512, 512) == 1
    fake = types.SimpleNamespace(device=torch.device("cpu"), cfg=bf16)
    assert MGLDVSRPipeline.patch_batch_envelope(fake, 512, 512) == 1

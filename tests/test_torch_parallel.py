"""The port's multi-process restore on the CPU: ranks in gloo processes
against the JAX package's multi-device functions on its virtual CPU devices.

Each rank is a child process spawned here that blocks every import of JAX
and the JAX package, runs torch on one thread, and joins a gloo group through
a ``file://`` store under the test's temporary directory (no TCP port:
several test workers share the machine). Every spawn has its own deadline
and every process group its own timeout, so a hang fails one test. Children
write their results to files; this process compares them.

Tolerances: the sharded sampler 1e-5 and the window-parallel restore 1e-4,
as the JAX package's own tests hold it against its per-window path
(``test_sharded_sampler.py``, ``test_window_parallel.py``); the
patch-parallel restore 2e-5 against one rank (``test_patch_parallel.py``).
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.core.diffusion import SamplerConfig as JaxSamplerConfig
from mgldvsr_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from mgldvsr_tpu.core.schedules import respace_schedule as jax_respace
from mgldvsr_tpu.parallel import sharded_sampler as jax_sharded
from mgldvsr_tpu.parallel.mesh import make_mesh
from mgldvsr_tpu_torch.cli import infer as cli
from mgldvsr_tpu_torch.core.diffusion import SamplerConfig, sample_video
from mgldvsr_tpu_torch.core.schedules import DiffusionSchedule, respace_schedule
from mgldvsr_tpu_torch.io import frames as frames_io
from mgldvsr_tpu_torch.io import from_jax
from mgldvsr_tpu_torch.parallel import mesh
from mgldvsr_tpu_torch.parallel import sharded_sampler as ss
from tests.test_pipeline import tiny_config
from tests.test_torch_models import jax_pipeline_and_params, numpy_tree, port_config
from tests.test_torch_pipeline import _frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what every child runs first: no JAX, one thread, the arguments as a dict
_PRELUDE = r"""
import datetime, os, sys
for name in ("jax", "jaxlib", "flax", "optax", "mgldvsr_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
from mgldvsr_tpu_torch.parallel import mesh
args = dict(a.split("=", 1) for a in sys.argv[1:])
out = args["out"]
rank = int(os.environ["RANK"])
TIMEOUT = datetime.timedelta(seconds=90)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_ranks(tmp_path, body: str, world: int, timeout: float = 240, **args):
    """Run ``body`` (after the prelude) in ``world`` child processes, ranks
    0..world-1 of a gloo group whose ``file://`` stores live in ``tmp_path``
    (``args["init"]`` and ``args["init2"]``); fail if any exits non-zero or
    all have not finished within ``timeout`` seconds (then kill them)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(WORLD_SIZE=str(world), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    argv = [f"out={tmp_path}", f"init=file://{tmp_path / 'store'}",
            f"init2=file://{tmp_path / 'store2'}", *(f"{k}={v}" for k, v in args.items())]
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(tmp_path / f"rank{r}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _PRELUDE + body, *argv], cwd=REPO,
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=log,
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (f"rank {r} exited {p.returncode}:\n"
                                   f"{(tmp_path / f'rank{r}.log').read_text()[-4000:]}")


# -- the boundary term -------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 8, 8, 4), (1, 7, 5, 4)])
def test_boundary_grad_matches_autograd_and_jax(shape):
    """d/d last of the boundary loss, the neighbour constant: against
    autograd of ``boundary_loss_plain`` and ``jax.grad`` of the JAX
    package's ``_boundary_loss``, within 1e-6 of max |grad| (each entry is 0
    or ±1/(h·w·c)); some pixels occluded."""
    rs = np.random.RandomState(shape[1])
    last, nb = rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)
    bflow = (2 * rs.randn(*shape[:3], 2)).astype(np.float32)
    bocc = (rs.rand(*shape[:3], 1) > 0.7).astype(np.float32)
    t = [torch.from_numpy(a) for a in (last, nb, bflow, bocc)]
    got = ss.boundary_grad(*t)

    leaf = t[0].clone().requires_grad_(True)
    ss.boundary_loss_plain(leaf, *t[1:]).backward()
    want = jax.grad(lambda l: jax_sharded._boundary_loss(l, nb, bflow, bocc, 1))(last)
    limit = 1e-6 * float(np.abs(np.asarray(want)).max())
    assert float(np.abs(np.asarray(want)).max()) == pytest.approx(1.0 / last.size)
    np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), atol=limit, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=limit, rtol=0)
    assert 0 < (got != 0).float().mean() < 1


# -- the sampler in three ranks ---------------------------------------------

_SAMPLER_CHILD = r"""
from mgldvsr_tpu_torch.core.diffusion import SamplerConfig
from mgldvsr_tpu_torch.core.schedules import DiffusionSchedule, respace_schedule
from mgldvsr_tpu_torch.parallel import sharded_sampler as ss
d = dict(np.load(args["inputs"]))
t = int(args["t"])
mesh.init_group("cpu", args["init"], timeout=TIMEOUT)
w = slice(rank * t, (rank + 1) * t)
one = lambda k: torch.from_numpy(d[k][rank:rank + 1])
sched = respace_schedule(DiffusionSchedule.create(timesteps=100, device="cpu"), 4)
cfg = SamplerConfig(num_frames=t, guidance_scale=-5.0, temperature=0.0)
for weight in (1.0, 0.0):
    x = ss.sample_video_sharded(
        sched, lambda x, tt: 0.1 * x, torch.from_numpy(d["x_T"][w]), None, cfg,
        (one("ff"), one("fb")), (one("of"), one("ob")), one("bflow"), one("bocc"),
        boundary_weight=weight)
    np.save(f"{out}/rank{rank}_w{weight:g}.npy", x.numpy())
mesh.destroy()
"""


def test_sample_video_sharded_matches_jax_in_three_ranks(tmp_path):
    """Three gloo ranks, a window of 3 frames of 8x8x4 each, a fixed
    denoiser, temperature 0: at boundary_weight 1 the JAX package's
    ``sample_video_sharded`` on three virtual devices (same x_T, flows,
    masks, boundary flows and masks) within 1e-5; at 0 each rank equals the
    port's ``sample_video`` of its window alone; and the weight moves every
    window but the last."""
    d, t, h, w, c = 3, 3, 8, 8, 4
    rs = np.random.RandomState(0)
    f32 = np.float32
    inp = {"x_T": rs.randn(d * t, h, w, c).astype(f32),
           "ff": (0.3 * rs.randn(d, t - 1, h, w, 2)).astype(f32),
           "fb": (0.3 * rs.randn(d, t - 1, h, w, 2)).astype(f32),
           "of": (rs.rand(d, t - 1, h, w, 1) > 0.8).astype(f32),
           "ob": (rs.rand(d, t - 1, h, w, 1) > 0.8).astype(f32),
           "bflow": (0.3 * rs.randn(d, h, w, 2)).astype(f32),
           "bocc": (rs.rand(d, h, w, 1) > 0.8).astype(f32)}
    np.savez(tmp_path / "inputs.npz", **inp)
    run_ranks(tmp_path, _SAMPLER_CHILD, d, inputs=tmp_path / "inputs.npz", t=t)
    got = {wt: np.concatenate([np.load(tmp_path / f"rank{r}_w{wt}.npy") for r in range(d)])
           for wt in ("1", "0")}

    jsched = jax_respace(JaxSchedule.create(timesteps=100, beta_schedule="linear",
                                            linear_start=0.00085, linear_end=0.012), 4)
    jcfg = JaxSamplerConfig(num_frames=t, guidance_scale=-5.0, temperature=0.0)
    want = jax.jit(lambda x: jax_sharded.sample_video_sharded(
        make_mesh(d, tp=1), jsched, lambda x_, tt: 0.1 * x_, x, jax.random.PRNGKey(0), jcfg,
        (inp["ff"], inp["fb"]), (inp["of"], inp["ob"]), inp["bflow"], inp["bocc"],
        boundary_weight=1.0))(jnp.asarray(inp["x_T"]))
    np.testing.assert_allclose(got["1"], np.asarray(want), atol=1e-5, rtol=0)

    sched = respace_schedule(DiffusionSchedule.create(timesteps=100, device="cpu"), 4)
    cfg = SamplerConfig(num_frames=t, guidance_scale=-5.0, temperature=0.0)
    for r in range(d):
        win = slice(r * t, (r + 1) * t)
        one = {k: torch.from_numpy(inp[k][r:r + 1]) for k in ("ff", "fb", "of", "ob")}
        alone = sample_video(sched, lambda x, tt: 0.1 * x, torch.from_numpy(inp["x_T"][win]),
                             None, cfg, (one["ff"], one["fb"]), (one["of"], one["ob"])).latents
        np.testing.assert_array_equal(got["0"][win], alone.numpy(), err_msg=f"window {r}")
        moved = not np.array_equal(got["1"][win], got["0"][win])
        assert moved == (r < d - 1), f"window {r}: the boundary term moved it: {moved}"


def test_a_cuda_group_is_never_gloo(monkeypatch):
    """Asked for CUDA on a machine without it, ``init_group`` raises before
    it joins anything; it does not fall back to gloo or the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.init_group("cuda", "file:///nonexistent/store")
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("RANK")
    with pytest.raises(RuntimeError, match="RANK"):
        mesh.init_group("cpu", "file:///nonexistent/store")


# -- the window-parallel restore in two ranks --------------------------------

_RESTORE_CHILD = r"""
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
blob = torch.load(args["blob"], weights_only=False)
pipe = MGLDVSRPipeline(blob["cfg"], device="cpu")
for name, sd in blob["state"].items():
    pipe.towers()[name].load_state_dict(sd, strict=True)
frames = torch.from_numpy(blob["frames"])
mesh.init_group("cpu", args["init"], timeout=TIMEOUT)
for weight in (1.0, 0.0):
    got = pipe.restore_windows_sharded(frames, boundary_weight=weight, deterministic=True)
    np.save(f"{out}/rank{rank}_w{weight:g}.npy", got.numpy())
for bad, why in ((frames[:3], "multiple of num_frames"), (frames[:2], "one rank per window")):
    try:
        pipe.restore_windows_sharded(bad, deterministic=True)
    except ValueError as e:
        assert why in str(e), e
    else:
        raise AssertionError(f"{tuple(bad.shape)} frames in 2 ranks did not raise")
mesh.destroy()
"""


@pytest.fixture(scope="module")
def window_pipes():
    """The JAX tiny pipeline at num_frames 2 and the port's config and state
    dicts with the same weights; RAFT's last flow-head conv scaled by 1e-2 on
    both sides, so guidance and the boundary term act."""
    jcfg = tiny_config(num_frames=2, ddpm_steps=2)
    jpipe, params = jax_pipeline_and_params(jcfg, size=64)
    params = numpy_tree(params)
    params["raft"]["params"]["update_scan"]["update_block"]["flow_head_conv2"]["kernel"] *= 1e-2
    cfg = port_config(jcfg)
    return jpipe, jax.tree_util.tree_map(jnp.asarray, params), cfg, \
        from_jax.pipeline_state_dicts(params, cfg)


def test_restore_windows_sharded_matches_jax_in_two_ranks(tmp_path, window_pipes):
    """Two windows of 2 frames at 64x64, one a gloo rank, deterministic, at
    boundary_weight 1: the JAX package's ``restore_windows_sharded`` on two
    virtual devices within 1e-4. At 0 window 1 (no right neighbour) is the
    same and window 0 is not. Frame counts that are not a multiple of the
    window, or not one window a rank, raise."""
    jpipe, params, cfg, state = window_pipes
    frames = np.concatenate([_frames(5, n=2), _frames(6, n=2)])
    torch.save({"cfg": cfg, "state": state, "frames": frames}, tmp_path / "blob.pt")
    run_ranks(tmp_path, _RESTORE_CHILD, 2, blob=tmp_path / "blob.pt")
    got = {wt: np.concatenate([np.load(tmp_path / f"rank{r}_w{wt}.npy") for r in range(2)])
           for wt in ("1", "0")}
    want = jpipe.restore_windows_sharded(params, jnp.asarray(frames), jax.random.PRNGKey(0),
                                         devices=jax.devices()[:2], boundary_weight=1.0,
                                         deterministic=True)
    assert got["1"].shape == (4, 64, 64, 3)
    np.testing.assert_allclose(got["1"], np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got["1"][2:], got["0"][2:])
    assert np.abs(got["1"][:2] - got["0"][:2]).max() > 1e-6


# -- the patch-parallel tile restore in two ranks ----------------------------

_PATCH_CHILD = r"""
from mgldvsr_tpu_torch.cli.infer import tiny_pipeline_config
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights
pipe = MGLDVSRPipeline(tiny_pipeline_config(torch.float32, num_frames=2, ddpm_steps=2), "cpu")
init_pipeline_weights(pipe, 0)
with torch.no_grad():
    pipe.raft.update_block.flow_head.conv2.weight.mul_(1e-2)
lq = torch.from_numpy(np.load(args["lq"]))
mesh.init_group("cpu", args["init"], timeout=TIMEOUT)
gen = torch.Generator().manual_seed(2)
got = pipe.restore_video(lq, gen, pch_size=64, pch_stride=48, min_side=64, use_guidance=True,
                         patch_group=mesh.subgroup(2))
np.save(f"{out}/rank{rank}.npy", got.numpy())
mesh.destroy()
"""


def test_patch_parallel_equals_one_rank(tmp_path):
    """Tile mode, guided, sampling with a generator: six 64px patches over
    two gloo ranks give, on both ranks, the frames of one process's
    ``restore_video`` within 2e-5."""
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights

    lq = np.random.RandomState(1).rand(2, 24, 40, 3).astype(np.float32)
    np.save(tmp_path / "lq.npy", lq)
    run_ranks(tmp_path, _PATCH_CHILD, 2, lq=tmp_path / "lq.npy")
    pipe = MGLDVSRPipeline(cli.tiny_pipeline_config(torch.float32, num_frames=2, ddpm_steps=2),
                           "cpu")
    init_pipeline_weights(pipe, 0)
    with torch.no_grad():
        pipe.raft.update_block.flow_head.conv2.weight.mul_(1e-2)
    want = pipe.restore_video(torch.from_numpy(lq), torch.Generator().manual_seed(2),
                              pch_size=64, pch_stride=48, min_side=64, use_guidance=True)
    assert want.shape == (2, 96, 160, 3)
    for r in range(2):
        np.testing.assert_allclose(np.load(tmp_path / f"rank{r}.npy"), want.numpy(), atol=2e-5,
                                   rtol=0, err_msg=f"rank {r}")


# -- the command line in two ranks -------------------------------------------

_CLI_CHILD = r"""
from mgldvsr_tpu_torch.cli import infer as cli
from mgldvsr_tpu_torch.data.video_folder import VideoFolderDataset
from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
argv = ["--seqs-path", args["seqs"], "--out-path", f"{out}/cli", "--preset", "tiny",
        "--no-bf16", "--ddpm-steps", "2", "--device", "cpu", "--seed", "5"]
cli.main([*argv, "--window-parallel", "--init-method", args["init"]])
assert not torch.distributed.is_initialized()
# the direct calls: the same pipeline and generators as the command line
a = cli.parse_args(argv)
pipe = cli.build_pipeline(a)
cli.load_weights(pipe, a)
segs = list(VideoFolderDataset(args["seqs"], 5).segments(0))
seed = lambda names: cli.segment_seed(5, "clip0", names[0])
to8 = lambda x: (x.clamp(0, 1) * 255).round().to(torch.uint8).numpy()
mesh.init_group("cpu", args["init2"], timeout=TIMEOUT)
frames = upscale_frames(torch.from_numpy(np.concatenate([f for _, _, f in segs[:2]])), 4)
got = pipe.restore_windows_sharded(frames, torch.Generator().manual_seed(seed(segs[0][1])))
np.save(f"{out}/direct{rank}.npy", to8(got))
if rank == 0:
    _, names, f = segs[2]
    got = pipe.restore_segment(upscale_frames(torch.from_numpy(f), 4),
                               torch.Generator().manual_seed(seed(names)))
    np.save(f"{out}/direct2.npy", to8(got))
mesh.destroy()
"""


def test_cli_window_parallel_writes_the_direct_restore(tmp_path):
    """``cli.infer --window-parallel --device cpu --preset tiny`` in two
    gloo ranks on an 11-frame clip: windows 0 and 1 restored together (each
    rank writes its own), the padded remainder window by rank 0 alone. Every
    PNG equals the direct calls' frames: ``restore_windows_sharded`` of the
    first two windows and ``restore_segment`` of the third, with the
    command line's generators."""
    from tests.test_torch_cli import _write_clip

    seqs = tmp_path / "lq"
    _write_clip(str(seqs), "clip0", 11, 16, 16, seed=3)
    run_ranks(tmp_path, _CLI_CHILD, 2, seqs=seqs)
    names = sorted(os.listdir(tmp_path / "cli" / "clip0"))
    assert names == [f"{i:08d}.png" for i in range(11)]
    want = np.concatenate([np.load(tmp_path / f"direct{w}.npy") for w in range(3)])
    for i, name in enumerate(names):
        np.testing.assert_array_equal(
            frames_io.read_frame(str(tmp_path / "cli" / "clip0" / name)), want[i], err_msg=name)


# -- the multi-card check in two ranks ---------------------------------------

_MULTICARD_CHILD = r"""
from mgldvsr_tpu_torch.tools import multicard_check
sys.exit(multicard_check.main(["--device", "cpu", "--preset", "tiny", "--steps", "2",
                               "--init-method", args["init"], "--timeout", "90"]))
"""


def test_multicard_check_passes_in_two_ranks(tmp_path):
    """``tools/multicard_check`` at the tiny preset in two gloo ranks: every
    check bit for bit (the sharded restore at weight 0 against
    ``restore_segment``, at weight 1 against the lockstep in one process,
    the patch-parallel tile restore against one rank), the boundary term
    moving window 0 and not window 1."""
    import json

    run_ranks(tmp_path, _MULTICARD_CHILD, 2)
    report = json.loads((tmp_path / "rank0.log").read_text().strip().splitlines()[-1])
    assert report["ok"] and report["world"] == 2
    assert report["checks"] == {"a_w0_equals_restore_segment_on_every_rank": True,
                                "c_tile_patch_parallel_equals_alone": True,
                                "b_w1_equals_lockstep": True,
                                "boundary_term_moved_all_but_the_last": [True, False]}
    assert set(report["per_rank"]) >= {"segment_sampler_ms", "sharded_w1_sampler_ms"}

"""Data-parallel training of the port on the CPU: gloo ranks, one clip
each, against the JAX package's single-process step on the batch of every
rank's clip, at tiny widths, float32.

The JAX command line's ``--mesh`` puts one clip on each ``data`` slot and
runs one jitted step over the concatenated batch, so the reference of D
ranks is that step on D clips: every loss a mean over the whole batch,
every divisor the whole batch's, batch statistics over all of it. The ranks
are child processes (``tests/test_torch_parallel.run_ranks``: a ``file://``
store, one torch thread each, JAX blocked, a deadline a spawn and a timeout
a group); each starts from the JAX start state converted here
(``io.from_jax``), takes its clip's slice of JAX's draws and writes what it
holds. The children run while the JAX reference compiles.

Limits. Stage 1 as ``test_torch_train.py`` holds one process against JAX:
the loss within 1e-5 relative, a gradient leaf (the accumulator after
micro-step 1) within 3e-4 of its max |g| plus 1e-6 of the largest;
``grad_norm``, which one process's test holds to 1e-4 of a loss near 1,
within 1e-4 relative (a norm near 8.6 here, measured 3.7e-5 off). After the
update (micro-step 2) ``mu`` (0.1 g) within the gradient's limit, ``nu``
(0.001 g²) within twice it; the masters and EMA shadows as chip_smoke phase
8 (a) holds parameters after Adam's first step (an element moves by
lr·g/(|g|+1e-8), so a gradient within rounding of zero may take either
sign): within 2·lr, and at most 1% of the elements more than 1e-6 away
among the leaves whose gradient is above rounding. The ranks' gradient
equals the mean of the clips' gradients taken one at a time in one process
bit for bit; ZeRO-1 equals the replicated ranks within 1e-6 of each leaf's
max. Stage 2 as ``test_torch_stage2.py``: the metrics within 1e-5 relative
(1e-5 of the logits' scale for the GAN terms), the running statistics
within 1e-6, the trainables, logvar and the discriminator's parameters
after the update as stage 1's masters, the discriminator's gradient and
moments within 1e-4 of each leaf's max. A generator gradient leaf within
3e-4 of its max (stage 1's limit), or within 1.5x the distance at which the
port in one process on the same 2-clip batch stands from JAX: the temporal
blend scalars, whose gradient sums a block's whole output, stand 1.6e-3 of
their value from JAX there (under 2e-5 on the one clip of
``test_torch_stage2.py``). What the ranks add to that one-process step is
held apart, and tightly, generator moments included
(``test_stage2_ranks_equal_one_process_on_the_batch``).

Kinks. A ReLU or hinge input within rounding of zero sends the leaves
behind it to the other side when the sums run in another order: here
SPADE's ``mlp_shared`` in the UNet's second input block (8% of the leaf's
max, and the struct-cond ``fea_tran`` leaves that feed it, under 1%). As
``test_torch_stage2.py`` does for the discriminator, each gradient and
moment leaf may then stand from JAX by 1.5x the distance a witness moves it:
the same ranks with the clips moved by 1e-5 relative (stage 1, chip_smoke
phase 8 (a)'s scale for SPADE's kink) or the latents by 1e-6 (stage 2). The
stage-1 witness must cross such a kink (a leaf moved by more than 1e-2 of
its max), so that it shows what it is used for.
"""
import concurrent.futures
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.infer.pipeline import MGLDVSRPipeline as JaxPipeline
from mgldvsr_tpu.parallel import mesh as jmesh
from mgldvsr_tpu.train import stage2 as jstage2
from mgldvsr_tpu.train import trainer as jtrainer
from mgldvsr_tpu_torch.cli import train as cli
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
from mgldvsr_tpu_torch.io import from_jax
from mgldvsr_tpu_torch.io.frames import write_frame
from mgldvsr_tpu_torch.io.checkpoint import CheckpointManager
from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights, jitter_weights
from mgldvsr_tpu_torch.models.vae import VideoAutoencoderKLResi
from mgldvsr_tpu_torch.parallel import mesh
from mgldvsr_tpu_torch.train import stage2 as pstage2
from mgldvsr_tpu_torch.train import trainer as ptrainer
from tests.test_pipeline import tiny_config
from tests.test_torch_models import numpy_tree, port_config
from tests.test_torch_parallel import run_ranks
from tests.test_torch_stage2 import _assert_leaves_close, _calm_spynet, _disc_names, _gen_names
from tests.test_torch_stage2_cli import _argv as _stage2_argv
from tests.test_torch_stage2_cli import roots  # noqa: F401  (a fixture: stage 2's data)
from tests.test_torch_train import _jax_params, _port_names

torch.set_num_threads(1)
D = 2  # ranks, and clips in JAX's batch
N, SIZE = 5, 32  # stage 1: frames a clip, GT size
T = 3  # stage 2: frames a clip
LR = 5e-5
MIN_SIZE = 1024  # ZeRO-1's threshold here: the tiny models' leaves are small
# the tensor rule's width here: the tiny towers' 64-wide levels, their
# time embeddings, GEGLUs, CLIP's projections and RAFT are split
MIN_OUT = 64
TP = 2  # the grid's tensor axis: D x TP ranks


def _rand(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _in_background(fn, *args, **kwargs):
    """Run ``fn`` (the ranks) in a thread while the caller compiles JAX."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(fn, *args, **kwargs)
    pool.shutdown(wait=False)
    return future


def _load(tmp, name):
    return torch.load(tmp / name, weights_only=False)


# ---------------------------------------------------------------------------
# stage 1
# ---------------------------------------------------------------------------

_STAGE1_CHILD = r"""
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
from mgldvsr_tpu_torch.io.checkpoint import CheckpointManager
from mgldvsr_tpu_torch.train import trainer as T
blob = torch.load(args["blob"], weights_only=False)
d = dict(np.load(args["draws"]))
mesh.init_group("cpu", args["init"], timeout=TIMEOUT)
grid = mesh.init_grid(1)
rows = slice(rank * int(args["n"]), (rank + 1) * int(args["n"]))


def clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree


mesh.ZERO1_MIN_SIZE = int(args["min_size"])
for name, zero1, clips in (("replicated", False, ""), ("zero1", True, ""),
                           ("witness", False, "_moved")):
    lq, gt = (torch.from_numpy(d[k + clips][rows]) for k in ("lq", "gt"))
    pipe = MGLDVSRPipeline(blob["cfg"], device="cpu")
    for tower, sd in blob["towers"].items():
        pipe.towers()[tower].load_state_dict(sd)
    tr = T.Stage1Trainer(pipe, T.Stage1Config(grad_accum=2), grid=grid, zero1=zero1)
    state = tr.shard(CheckpointManager(args["ckpt"]).restore(0, template=tr.init_state()))
    snaps = []
    for k in (0, 1):
        draws = T.Stage1Draws(*(torch.from_numpy(d[f"{f}{k}"][rows])
                                for f in ("lq_post", "gt_post", "t", "noise")))
        state, m = tr.train_step(state, lq, gt, draws=draws)
        snaps.append({"metrics": {k_: float(v) for k_, v in m.items()},
                      "trainable": clone(state.trainable), "ema": clone(state.ema),
                      "opt": clone({k_: state.opt_state[k_] for k_ in ("mu", "nu", "acc")})})
    full = tr.gather(state)
    torch.save({"snaps": snaps, "axes": tr.zero.axes,
                "full": {"mu": clone(full.opt_state["mu"]), "ema": clone(full.ema)}},
               f"{out}/s1_{name}_rank{rank}.pt")


def run_clip0(grid, clips=""):
    # clip 0, two micro-steps (the update): the whole state after each
    pipe = MGLDVSRPipeline(blob["cfg"], device="cpu")
    for tower, sd in blob["towers"].items():
        pipe.towers()[tower].load_state_dict(sd)
    tr = T.Stage1Trainer(pipe, T.Stage1Config(grad_accum=2), grid=grid)
    state = tr.shard(CheckpointManager(args["ckpt"]).restore(0, template=tr.init_state()))
    clip = slice(0, int(args["n"]))
    snaps = []
    for k in (0, 1):
        draws = T.Stage1Draws(*(torch.from_numpy(d[f"{f}{k}"][clip])
                                for f in ("lq_post", "gt_post", "t", "noise")))
        state, m = tr.train_step(state, torch.from_numpy(d["lq" + clips][clip]),
                                 torch.from_numpy(d["gt" + clips][clip]), draws=draws)
        full = tr.gather(state)
        snaps.append({"trainable": clone(full.trainable), "ema": clone(full.ema),
                      "opt": clone({k_: full.opt_state[k_] for k_ in ("mu", "nu", "acc")})})
    split = [k for k, v in state.trainable.items() if v.shape != full.trainable[k].shape]
    return snaps, split


# a 1 x 2 grid: both ranks take clip 0 and split the towers, in both configurations
mesh.TENSOR_MIN_OUT = int(args["min_out"])
grid = mesh.init_grid(2)
for fused in ("0", "1"):
    os.environ["MGLD_FUSED_GN_CONV"] = fused
    snaps, split = run_clip0(grid)
    torch.save({"snaps": snaps, "split": split}, f"{out}/s1_tensor{fused}_rank{rank}.pt")
mesh.destroy()
if rank == 0:  # one process on clip 0 (and moved: the witness), in both configurations
    for fused in ("0", "1"):
        os.environ["MGLD_FUSED_GN_CONV"] = fused
        torch.save(run_clip0(None)[0], f"{out}/s1_clip0_fused{fused}.pt")
        torch.save(run_clip0(None, "_moved")[0], f"{out}/s1_clip0_moved{fused}.pt")
    os.environ["MGLD_FUSED_GN_CONV"] = "0"
    # one process taking the clips one at a time: micro-step 1's gradients
    accs = []
    for r in range(int(args["clips"])):
        pipe = MGLDVSRPipeline(blob["cfg"], device="cpu")
        for tower, sd in blob["towers"].items():
            pipe.towers()[tower].load_state_dict(sd)
        tr = T.Stage1Trainer(pipe, T.Stage1Config(grad_accum=2))
        state = CheckpointManager(args["ckpt"]).restore(0, template=tr.init_state())
        clip = slice(r * int(args["n"]), (r + 1) * int(args["n"]))
        draws = T.Stage1Draws(*(torch.from_numpy(d[f"{f}0"][clip])
                                for f in ("lq_post", "gt_post", "t", "noise")))
        state, _ = tr.train_step(state, torch.from_numpy(d["lq"][clip]),
                                 torch.from_numpy(d["gt"][clip]), draws=draws)
        accs.append(clone(state.opt_state["acc"]))
    torch.save(accs, f"{out}/s1_one_at_a_time.pt")
"""


_GRID1_CHILD = r"""
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
from mgldvsr_tpu_torch.io.checkpoint import CheckpointManager
from mgldvsr_tpu_torch.train import trainer as T
blob = torch.load(args["blob"], weights_only=False)
d = dict(np.load(args["draws"]))
mesh.init_group("cpu", args["init"], timeout=TIMEOUT)
mesh.ZERO1_MIN_SIZE = int(args["min_size"])
mesh.TENSOR_MIN_OUT = int(args["min_out"])
grid = mesh.init_grid(int(args["tp"]))
rows = slice(grid.data_index * int(args["n"]), (grid.data_index + 1) * int(args["n"]))
lq, gt = (torch.from_numpy(d[k][rows]) for k in ("lq", "gt"))


def clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree


for name, zero1 in (("grid", False), ("grid_zero1", True)):
    pipe = MGLDVSRPipeline(blob["cfg"], device="cpu")
    for tower, sd in blob["towers"].items():
        pipe.towers()[tower].load_state_dict(sd)
    tr = T.Stage1Trainer(pipe, T.Stage1Config(grad_accum=2), grid=grid, zero1=zero1)
    state = tr.shard(CheckpointManager(args["ckpt"]).restore(0, template=tr.init_state()))
    snaps = []
    for k in (0, 1):
        draws = T.Stage1Draws(*(torch.from_numpy(d[f"{f}{k}"][rows])
                                for f in ("lq_post", "gt_post", "t", "noise")))
        state, m = tr.train_step(state, lq, gt, draws=draws)
        full = tr.gather(state)
        snaps.append({"metrics": {k_: float(v) for k_, v in m.items()},
                      "trainable": clone(full.trainable), "ema": clone(full.ema),
                      "opt": clone({k_: full.opt_state[k_] for k_ in ("mu", "nu", "acc")})})
    shapes = {k: tuple(v.shape) for k, v in state.opt_state["mu"].items()}
    towers = {t: sum(p.numel() for p in m.parameters()) for t, m in pipe.towers().items()}
    torch.save({"snaps": snaps, "zero_axes": tr.zero.axes, "tensor_axes": tr.zero.tensor.axes,
                "mu_shapes": shapes, "tower_elements": towers, "grid": (grid.dp, grid.tp)},
               f"{out}/s1_{name}_rank{rank}.pt")
mesh.destroy()
"""


def _draws(key, frames):
    """The JAX trainer's four draws from ``key`` for ``frames`` frames."""
    lat = (frames, SIZE // 8, SIZE // 8, 4)
    k1, k2, kt, kn = jax.random.split(key, 4)
    return {"lq_post": np.array(jax.random.normal(k1, lat)),
            "gt_post": np.array(jax.random.normal(k2, lat)),
            "t": np.array(jax.random.randint(kt, (frames,), 0, 1000, dtype=jnp.int32)),
            "noise": np.array(jax.random.normal(kn, lat))}


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """Two gloo ranks, grad_accum 2, two micro-steps, replicated and with
    ZeRO-1 (threshold ``MIN_SIZE``), against the JAX step on the 2-clip
    batch."""
    tmp = tmp_path_factory.mktemp("s1")
    jcfg = tiny_config(ddpm_steps=2)
    cfg = port_config(jcfg)
    jtr = jtrainer.Stage1Trainer(JaxPipeline(jcfg), jtrainer.Stage1Config(grad_accum=2))
    state0 = jax.device_get(jtr.init_state(_jax_params(jcfg, cfg)))
    lq = np.concatenate([_rand((N, SIZE, SIZE, 3), 2 * r) for r in range(D)])
    gt = np.concatenate([_rand((N, SIZE, SIZE, 3), 2 * r + 1) for r in range(D)])
    keys = [jax.random.PRNGKey(2), jax.random.PRNGKey(3)]
    draws = {f"{f}{k}": a for k, key in enumerate(keys) for f, a in _draws(key, D * N).items()}
    # the witness's clips: moved by 1e-5 relative
    rs = np.random.RandomState(5)
    moved = {k + "_moved": (a * (1 + 1e-5 * rs.randn(*a.shape))).astype(np.float32)
             for k, a in (("lq", lq), ("gt", gt))}
    np.savez(tmp / "draws.npz", lq=lq, gt=gt, **moved, **draws)
    tr = ptrainer.Stage1Trainer(MGLDVSRPipeline(cfg, device="cpu"),
                                ptrainer.Stage1Config(grad_accum=2))
    start = from_jax.train_state_from_jax(state0, tr)
    CheckpointManager(str(tmp / "ckpt")).save(0, start)
    torch.save({"cfg": cfg, "towers": {k: t.state_dict() for k, t in tr.pipe.towers().items()}},
               tmp / "blob.pt")
    ranks = _in_background(run_ranks, tmp, _STAGE1_CHILD, D, timeout=400,
                           blob=tmp / "blob.pt", draws=tmp / "draws.npz", ckpt=tmp / "ckpt",
                           n=N, min_size=MIN_SIZE, min_out=MIN_OUT, clips=D)
    (tmp / "grid").mkdir()
    grid = _in_background(run_ranks, tmp / "grid", _GRID1_CHILD, D * TP, timeout=400,
                          blob=tmp / "blob.pt", draws=tmp / "draws.npz", ckpt=tmp / "ckpt",
                          n=N, min_size=MIN_SIZE, min_out=MIN_OUT, tp=TP)
    step = jax.jit(jtr.train_step)
    states, metrics, state = [state0], [], state0
    for key in keys:
        state, m = step(state, jnp.asarray(lq), jnp.asarray(gt), key)
        states.append(jax.device_get(state))
        metrics.append(jax.device_get(m))
    ranks.result()
    grid.result()
    got = {name: [_load(tmp, f"s1_{name}_rank{r}.pt") for r in range(D)]
           for name in ("replicated", "zero1", "witness")}
    got.update({name: [_load(tmp / "grid", f"s1_{name}_rank{r}.pt") for r in range(D * TP)]
                for name in ("grid", "grid_zero1")})
    return dict(cfg=cfg, states=states, metrics=metrics, got=got, start=start,
                one_at_a_time=_load(tmp, "s1_one_at_a_time.pt"),
                tensor={f: [_load(tmp, f"s1_tensor{f}_rank{r}.pt") for r in range(D)]
                        for f in ("0", "1")},
                clip0={**{f: _load(tmp, f"s1_clip0_fused{f}.pt") for f in ("0", "1")},
                       **{"moved" + f: _load(tmp, f"s1_clip0_moved{f}.pt") for f in ("0", "1")}})


def _assert_grads_close(got, want, rel=3e-4, witness=None):
    """Each leaf within ``rel`` of its max |want| plus 1e-6 of the largest,
    or within 1.5x the witness's distance from ``got``."""
    top = max(float(w.abs().max()) for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        tol = rel * float(w.abs().max()) + 1e-6 * top
        if witness is not None:
            tol = max(tol, 1.5 * float((witness[k] - got[k]).abs().max()))
        err = float((got[k] - w).abs().max())
        assert err <= tol, (k, err, tol)


def _kink_jump(got, witness, want):
    """The largest leaf move from ``got`` to ``witness`` over the leaf's
    max |want|."""
    return max(float((witness[k] - got[k]).abs().max()) / float(w.abs().max())
               for k, w in want.items() if float(w.abs().max()) > 0)


def _assert_after_adam(got, want, grads):
    """Within 2·lr; at most 1% of the elements more than 1e-6 away among
    the leaves whose gradient ``grads`` reaches 1e-4 of the largest leaf's
    max (below that a leaf's gradient is rounding, |g| under ~1e-8, and
    Adam's first step lr·g/(|g|+1e-8) may land anywhere in [-lr, lr])."""
    top = max(float(g.abs().max()) for g in grads.values())
    off = total = 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        assert float(d.max()) <= 2 * LR + 1e-6, (k, float(d.max()))
        if float(grads[k].abs().max()) >= 1e-4 * top:
            off += int((d > 1e-6).sum())
            total += d.numel()
    assert off <= 0.01 * total, (off, total)


def _rank0_full(stage1, name, snap):
    """Rank 0's tensors of micro-step ``snap`` with the split ones whole
    (both ranks' slices put together along their axes; the grids' ranks
    saved their state gathered)."""
    ranks = stage1["got"][name]
    if name.startswith("grid"):
        got = ranks[0]["snaps"][snap]
        return {"trainable": got["trainable"], "ema": got["ema"], **got["opt"]}
    axes = ranks[0]["axes"]

    def whole(part, sub=None):
        pieces = [r["snaps"][snap][part] if sub is None else r["snaps"][snap][part][sub]
                  for r in ranks]
        return {k: torch.cat([p[k] for p in pieces], axes[k]) if k in axes else v
                for k, v in pieces[0].items()}

    return {"trainable": ranks[0]["snaps"][snap]["trainable"], "ema": whole("ema"),
            "mu": whole("opt", "mu"), "nu": whole("opt", "nu"), "acc": whole("opt", "acc")}


@pytest.mark.parametrize("name", ["replicated", "zero1", "grid", "grid_zero1"])
def test_stage1_two_ranks_match_the_jax_step_on_two_clips(stage1, name):
    """Micro-step 1: the group's loss and grad_norm, the accumulator (the
    whole batch's gradient), no update. Micro-step 2 (the update): the
    masters, both moments and the EMA shadows. ``grid``: the two clips on a
    2 x 2 grid of ranks (two a clip, the towers split by the tensor rule at
    ``MIN_OUT``), its state gathered."""
    m = stage1["got"][name][0]["snaps"][0]["metrics"]
    want = stage1["metrics"][0]
    loss = float(want["loss"])
    assert abs(m["loss"] - loss) <= 1e-5 * abs(loss)
    norm = float(want["grad_norm"])
    assert abs(m["grad_norm"] - norm) <= 1e-4 * norm
    j1, j2 = stage1["states"][1], stage1["states"][2]
    s1, s2 = _rank0_full(stage1, name, 0), _rank0_full(stage1, name, 1)
    w1, w2 = _rank0_full(stage1, "witness", 0), _rank0_full(stage1, "witness", 1)
    want = _port_names(j1.opt_state.acc_grads, stage1)
    assert _kink_jump(s1["acc"], w1["acc"], want) > 1e-2  # the witness crosses the kink
    _assert_grads_close(s1["acc"], want, witness=w1["acc"])
    start = stage1["start"].trainable
    assert all(torch.equal(start[k], v) for k, v in s1["trainable"].items())
    adam = from_jax._find(j2.opt_state, ("count", "mu", "nu"))
    _assert_after_adam(s2["trainable"], _port_names(j2.trainable, stage1), want)
    _assert_after_adam(s2["ema"], _port_names(j2.ema, stage1), want)
    _assert_grads_close(s2["mu"], _port_names(adam.mu, stage1), witness=w2["mu"])
    _assert_grads_close(s2["nu"], _port_names(adam.nu, stage1), rel=6e-4, witness=w2["nu"])
    assert not any(a.any() for a in s2["acc"].values())  # zeroed at the update


@pytest.mark.parametrize("name", ["replicated", "zero1"])
def test_stage1_ranks_average_the_clips_gradients_bit_for_bit(stage1, name):
    """The group's gradient of micro-step 1 is the mean of each clip's
    gradient taken one at a time in one process (one thread, as a rank),
    bit for bit: each rank's clip is its own, and the reduction sums two
    values and halves them. Stage 1 has no coupling across clips."""
    singles = stage1["one_at_a_time"]
    got = _rank0_full(stage1, name, 0)["acc"]
    for k, v in got.items():
        assert torch.equal(v, (singles[0][k] + singles[1][k]) / 2), k


def test_stage1_replicas_hold_the_same_masters(stage1):
    """After every micro-step every rank holds the same masters, bit for
    bit, replicated and under ZeRO-1 (where they are gathered from the
    slices), and on the grid (gathered from the tensor slices too)."""
    for name, ranks in stage1["got"].items():
        assert len(ranks[0]["snaps"]) == 2, name
        for other in ranks[1:]:
            for a, b in zip(ranks[0]["snaps"], other["snaps"]):
                assert all(torch.equal(a["trainable"][k], v)
                           for k, v in b["trainable"].items()), name


def _assert_close_or_kink(got, want, witness, rel=1e-6):
    """Each leaf within ``rel`` of its max |want| plus ``rel`` of the
    largest leaf's (leaves whose exact gradient is zero hold rounding), or,
    behind a kink, within 1.5x the distance at which ``witness`` (``want``'s
    run with its clips moved) stands from ``want``."""
    top = max(float(w.abs().max()) for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        tol = max(rel * (float(w.abs().max()) + top), 1.5 * float((witness[k] - w).abs().max()))
        err = float((got[k] - w).abs().max())
        assert err <= tol, (k, err, tol)


@pytest.mark.parametrize("name", ["grid", "grid_zero1"])
def test_stage1_grid_equals_the_data_parallel_ranks(stage1, name):
    """The 2 x 2 grid against the port's two data-parallel ranks on the
    same clips (replicated or ZeRO-1 as the grid): micro-step 1's loss and
    accumulator, micro-step 2's moments, within 1e-6 of each leaf's max (the
    split layers sum the input gradient in two parts and add the bias after
    the gather: rounding), or behind SPADE's kink within 1.5x the witness's
    distance (the rounding sends a few ReLU inputs within rounding of zero
    to the other side: struct-cond leaves move by 1.5e-4 of the largest
    leaf's max, where the witness moves them by 1e-2); grad_norm, which sums
    those leaves, within 1e-6 relative or 1.5x the witness's; the masters
    and EMA shadows after the update as above. The grid splits a share of
    every tower, trainables included, and each rank holds its slice of each
    split leaf's moments."""
    ref_name = "zero1" if name == "grid_zero1" else "replicated"
    grid = stage1["got"][name]
    assert grid[0]["grid"] == (D, TP)
    m, want = grid[0]["snaps"][0]["metrics"], stage1["got"][ref_name][0]["snaps"][0]["metrics"]
    moved = stage1["got"]["witness"][0]["snaps"][0]["metrics"]
    assert abs(m["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    tol = max(1e-6 * want["grad_norm"], 1.5 * abs(moved["grad_norm"] - want["grad_norm"]))
    assert abs(m["grad_norm"] - want["grad_norm"]) <= tol
    g1, r1 = _rank0_full(stage1, name, 0), _rank0_full(stage1, ref_name, 0)
    g2, r2 = _rank0_full(stage1, name, 1), _rank0_full(stage1, ref_name, 1)
    w1, w2 = _rank0_full(stage1, "witness", 0), _rank0_full(stage1, "witness", 1)
    _assert_close_or_kink(g1["acc"], r1["acc"], w1["acc"])
    for part in ("mu", "nu"):
        _assert_close_or_kink(g2[part], r2[part], w2[part])
    _assert_after_adam(g2["trainable"], r2["trainable"], r1["acc"])
    _assert_after_adam(g2["ema"], r2["ema"], r1["acc"])
    taxes = grid[0]["tensor_axes"]
    train = stage1["start"].trainable
    assert 0 < sum(k in taxes for k in train) < len(train)
    for tower in ("unet", "structcond", "vae", "clip", "raft"):
        assert any(k.startswith(tower + ".") for k in taxes), tower
    for k, shape in grid[0]["mu_shapes"].items():
        want_shape = list(train[k].shape)
        for axes in (taxes, grid[0]["zero_axes"]):
            if k in axes:
                want_shape[axes[k]] //= TP if axes is taxes else D
        assert list(shape) == want_shape, k


@pytest.mark.parametrize("fused", ["0", "1"])
def test_stage1_one_by_two_grid_equals_one_process(stage1, fused):
    """A 1 x 2 grid (both ranks on clip 0, the towers split) against one
    process on clip 0, in the default configuration and with
    ``MGLD_FUSED_GN_CONV=1`` (every chain's conv takes its rank's rows of
    the weight and the bias, the GroupNorm the whole input): the gathered
    accumulator of micro-step 1 and the moments of micro-step 2 as the
    grid against the data-parallel ranks (the witness: the one process on
    the moved clip); the gathered masters and EMA shadows after the update
    as above; both ranks gather the same."""
    ranks, one = stage1["tensor"][fused], stage1["clip0"][fused]
    witness = stage1["clip0"]["moved" + fused]
    assert ranks[0]["split"] and ranks[0]["split"] == ranks[1]["split"]
    got = ranks[0]["snaps"]
    _assert_close_or_kink(got[0]["opt"]["acc"], one[0]["opt"]["acc"], witness[0]["opt"]["acc"])
    for part in ("mu", "nu"):
        _assert_close_or_kink(got[1]["opt"][part], one[1]["opt"][part], witness[1]["opt"][part])
    _assert_after_adam(got[1]["trainable"], one[1]["trainable"], one[0]["opt"]["acc"])
    _assert_after_adam(got[1]["ema"], one[1]["ema"], one[0]["opt"]["acc"])
    for a, b in zip(got, ranks[1]["snaps"]):
        assert all(torch.equal(a["trainable"][k], v) for k, v in b["trainable"].items())


def test_zero1_splits_each_large_moment_in_half_along_the_jax_rule(stage1, monkeypatch):
    """Each rank holds half of every moment, accumulator and shadow of at
    least MIN_SIZE elements, along the axis the JAX package's
    ``_zero1_spec`` picks for the tensor's shape; the smaller ones whole.
    The gathered state is full size and equals the replicated run's
    within 1e-6 of each leaf's max."""
    monkeypatch.setattr(jmesh, "ZERO1_MIN_SIZE", MIN_SIZE)
    full = stage1["start"].trainable
    r0 = stage1["got"]["zero1"][0]
    axes = r0["axes"]

    class Leaf:
        def __init__(self, shape):
            self.shape, self.ndim, self.size = tuple(shape), len(shape), int(np.prod(shape))

    split = 0
    for k, v in full.items():
        spec = tuple(jmesh._zero1_spec(Leaf(tuple(v.shape)), jmesh.P(), D))
        assert axes.get(k) == (spec.index("data") if "data" in spec else None), k
        for part in ("mu", "nu", "acc"):
            got = r0["snaps"][0]["opt"][part][k]
            if k in axes:
                want = list(v.shape)
                want[axes[k]] //= D
                assert list(got.shape) == want, (k, part)
            else:
                assert got.shape == v.shape, (k, part)
        split += k in axes
    assert 0 < split < len(full)
    rep = _rank0_full(stage1, "replicated", 1)
    for part in ("mu", "ema"):
        gathered = r0["full"][part]
        for k, v in rep[part].items():
            assert gathered[k].shape == full[k].shape
            tol = 1e-6 * float(v.abs().max()) + 1e-12
            assert float((gathered[k] - v).abs().max()) <= tol, (part, k)


def test_zero1_spec_matches_jax(monkeypatch):
    """The port's rule against the JAX package's ``_zero1_spec`` on shapes
    of every kind (the axis JAX marks 'data'), at dp 2, 4 and 8."""
    class Leaf:
        def __init__(self, shape):
            self.shape, self.ndim, self.size = shape, len(shape), int(np.prod(shape))

    monkeypatch.setattr(jmesh, "ZERO1_MIN_SIZE", MIN_SIZE)
    shapes = [(320, 320, 3, 3), (1280,), (4, 320, 3, 3), (3, 8, 1, 1, 96), (64, 64, 1, 1),
              (1024,), (1023, 2), (6, 6, 6, 6), (2, 4096), (7, 7, 7, 7)]
    for dp in (2, 4, 8):
        for shape in shapes:
            spec = jmesh._zero1_spec(Leaf(shape), jmesh.P(), dp)
            want = list(spec).index("data") if "data" in tuple(spec) else None
            assert mesh.zero1_spec(shape, dp, MIN_SIZE) == want, (shape, dp)


def test_zero1_spec_on_a_tensor_slice_matches_jax(stage1, monkeypatch):
    """ZeRO-1 on a rank's tensor slice picks the axis that the JAX
    package's ``_zero1_spec(leaf, base, dp)`` picks for the global leaf
    with its tensor axis in ``base``: never the tensor axis, divisibility
    and the size threshold judged on the whole leaf (a slice under
    MIN_SIZE whose leaf is not is split). Shapes of every kind at dp 2 and
    4, and every trainable of the 2 x 2 grid's ZeRO-1 run."""
    class Leaf:
        def __init__(self, shape):
            self.shape, self.ndim, self.size = shape, len(shape), int(np.prod(shape))

    def want(shape, axis, dp):
        base = jmesh.P(*["tensor" if i == axis else None for i in range(len(shape))])
        spec = tuple(jmesh._zero1_spec(Leaf(shape), base, dp))
        return spec.index("data") if "data" in spec else None

    monkeypatch.setattr(jmesh, "ZERO1_MIN_SIZE", MIN_SIZE)
    cases = [((320, 320, 3, 3), 0), ((1280, 1280), 0), ((3072, 1024), 0), ((96, 32, 1), 0),
             ((640, 4, 3, 3), 0), ((128, 12), 0), ((256, 3, 3, 3, 3), 0), ((1024, 1024), None),
             ((64, 64, 1, 1), 0), ((4096, 7), 0)]
    assert mesh.zero1_spec((128, 12), 2, MIN_SIZE, tensor_axis=0) == 1  # its slice: 768
    for dp in (2, 4):
        for shape, axis in cases:
            assert mesh.zero1_spec(shape, dp, MIN_SIZE, tensor_axis=axis) == want(
                shape, axis, dp), (shape, axis, dp)
    run = stage1["got"]["grid_zero1"][0]
    split = 0
    for k, v in stage1["start"].trainable.items():
        axis = run["tensor_axes"].get(k)
        assert run["zero_axes"].get(k) == want(tuple(v.shape), axis, D), k
        split += k in run["zero_axes"] and axis is not None
    assert split  # leaves split both ways


def test_zero1_placement_holds_what_jax_places_on_a_device(stage1, monkeypatch):
    """``place_train_state(zero1=True)`` on a 2-device JAX mesh of the
    virtual CPU devices: device 0 holds as many Adam-moment elements as a
    port rank holds under ZeRO-1 with the same threshold."""
    monkeypatch.setattr(jmesh, "ZERO1_MIN_SIZE", MIN_SIZE)
    placed = jmesh.place_train_state(stage1["states"][0], jmesh.make_mesh(D, tp=1), zero1=True)
    adam = from_jax._find(placed.opt_state, ("count", "mu", "nu"))
    on_device0 = sum(leaf.addressable_shards[0].data.size
                     for leaf in jax.tree_util.tree_leaves(adam.mu))
    rank0 = sum(v.numel() for v in stage1["got"]["zero1"][0]["snaps"][0]["opt"]["mu"].values())
    total = sum(v.numel() for v in stage1["start"].trainable.values())
    assert on_device0 == rank0 < total


# ---------------------------------------------------------------------------
# the column-parallel layers alone
# ---------------------------------------------------------------------------

_LAYERS_CHILD = r"""
from mgldvsr_tpu_torch.models import layers
from mgldvsr_tpu_torch.models.cliptext import ResidualAttentionBlock
from mgldvsr_tpu_torch.parallel import tensor


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = layers.Conv1d(8, 12, 1)
        self.c2 = layers.Conv2d(8, 16, 3, padding=1)
        self.c3 = layers.Conv3d(16, 8, (3, 1, 1), padding=(1, 0, 0))
        self.norm = layers.GroupNorm(8, num_groups=4)
        self.chain = layers.conv3x3(8, 16)
        self.lin = layers.Linear(16, 6)
        self.block = ResidualAttentionBlock(16, 2, "gelu")

    def forward(self, x):  # [2, 8, 4, 4]
        a = self.c1(x.flatten(2))                                   # [2, 12, 16]
        b = self.c2(x)                                              # [2, 16, 4, 4]
        c = self.c3(b[:, :, None].expand(-1, -1, 3, -1, -1))        # [2, 8, 3, 4, 4]
        h = layers.norm_silu_conv(self.norm, self.chain, c.mean(2))  # [2, 16, 4, 4]
        t = self.block(h.flatten(2).transpose(1, 2), None)          # [2, 16, 16]
        return (a.square().mean() + self.lin(t).sin().sum() + c.square().mean()), t


mesh.init_group("cpu", args["init"], timeout=TIMEOUT)
grid = mesh.init_grid(2)
out_rows = {}
for fused in ("0", "1"):
    os.environ["MGLD_FUSED_GN_CONV"] = fused
    torch.manual_seed(0)
    whole, split = Net(), Net()
    for p in whole.parameters():
        torch.nn.init.normal_(p, std=0.3)
    split.load_state_dict(whole.state_dict())
    axes = {k: 0 for k, v in whole.named_parameters() if v.ndim >= 2 and "norm" not in k}
    tensor.shard_module(split, axes, grid)
    x = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(1))
    res = {}
    for name, net in (("whole", whole), ("split", split)):
        xi = x.clone().requires_grad_(True)
        loss, t = net(xi)
        loss.backward()
        grads = {k: v.grad for k, v in net.named_parameters()}
        if name == "split":
            grads = mesh.AxisSplit(axes, grid.tensor_group).gather(grads)
            res["state"] = tensor.gather_module_state(net)
        res[name] = {"loss": loss.detach(), "t": t.detach(), "dx": xi.grad, "grads": grads}
    res["split_names"] = tensor.split_parameters(split)
    res["whole_state"] = whole.state_dict()
    out_rows[fused] = res
torch.save(out_rows, f"{out}/layers_rank{rank}.pt")
mesh.destroy()
"""


def test_column_parallel_layers_equal_their_whole_forms(tmp_path):
    """Two gloo ranks split every conv (1-, 2- and 3-D), linear, CLIP's
    in-projection and a GroupNorm->SiLU->conv3x3 chain's conv of a small
    net by their output axes (``shard_module``), in the default
    configuration and with ``MGLD_FUSED_GN_CONV=1``: the loss, the
    activations, the input's gradient and every parameter's (the split
    ones gathered) equal the unsplit net's within 1e-6 relative (the input
    gradient summed in two parts, the bias added after the gather); the
    gathered state dict equals the unsplit one bit for bit; both ranks
    agree."""
    run_ranks(tmp_path, _LAYERS_CHILD, 2, timeout=120)
    ranks = [_load(tmp_path, f"layers_rank{r}.pt") for r in range(2)]
    for fused, got in ranks[0].items():
        assert len(got["split_names"]) == 9, got["split_names"]
        w, s = got["whole"], got["split"]
        for key in ("loss", "t", "dx"):
            scale = float(w[key].abs().max())
            assert float((s[key] - w[key]).abs().max()) <= 1e-6 * scale, (fused, key)
        for k, g in w["grads"].items():
            assert s["grads"][k].shape == g.shape, k
            err = float((s["grads"][k] - g).abs().max())
            assert err <= 1e-6 * float(g.abs().max()), (fused, k, err)
        assert all(torch.equal(got["state"][k], v) for k, v in got["whole_state"].items())
        other = ranks[1][fused]["split"]
        assert torch.equal(other["loss"], s["loss"]) and torch.equal(other["dx"], s["dx"])


# ---------------------------------------------------------------------------
# stage 2
# ---------------------------------------------------------------------------

_STAGE2_CHILD = r"""
from mgldvsr_tpu_torch.io.checkpoint import CheckpointManager
from mgldvsr_tpu_torch.models.vae import VideoAutoencoderKLResi
from mgldvsr_tpu_torch.parallel import tensor
from mgldvsr_tpu_torch.train import stage2 as S
blob = torch.load(args["blob"], weights_only=False)
d = dict(np.load(args["data"]))
mesh.init_group("cpu", args["init"], timeout=TIMEOUT)
mesh.TENSOR_MIN_OUT = int(args["min_out"])
grid = mesh.init_grid(int(args["tp"]))
rows = slice(grid.data_index * int(args["t"]), (grid.data_index + 1) * int(args["t"]))
lq, gt, lat = (torch.from_numpy(d[k][rows]) for k in ("lq", "gt", "lat"))


def clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree


def build():
    vae = VideoAutoencoderKLResi(blob["cfg"].vae)
    vae.load_state_dict(blob["vae"])
    tr = S.Stage2Trainer(vae, S.Stage2Config(**blob["s2cfg"]), grid=grid)
    tr.lpips.load_state_dict(blob["lpips"])
    tr.spynet.load_state_dict(blob["spynet"])
    return tr, tr.shard(CheckpointManager(args["ckpt"]).restore(0, template=tr.init_state()))


def snapshot(tr, state, m):
    full = tr.gather(state)  # whole: the grid's tensor slices put together
    return {"metrics": {k: float(v) for k, v in m.items()},
            "trainable": clone(full.trainable), "logvar": clone(full.logvar),
            "disc": clone(full.disc), "opt_g": clone(full.opt_g), "opt_d": clone(full.opt_d)}


runs = {}
for name, latents in (("ranks", lat), ("witness", torch.from_numpy(d["lat_moved"][rows]))):
    if grid.tp > 1 and name == "witness":
        continue
    tr, state = build()
    runs[name] = []
    for _ in range(2):
        state, m = tr.train_step(state, lq, gt, latents)
        runs[name].append(snapshot(tr, state, m))
if grid.tp > 1:  # the grid: each rank's whole state and the split leaves
    torch.save({"snaps": runs["ranks"], "tensor_axes": tr.zero.tensor.axes,
                "modules": {k: tensor.split_parameters(m) for k, m in tr.modules().items()}},
               f"{out}/s2_grid_rank{rank}.pt")
    mesh.destroy()
    sys.exit(0)
# the witness: each rank divides the NLL and frame-difference terms by its own rows
tr, state = build()
tr.batch_ranks = 1
_, m = tr.train_step(state, lq, gt, lat)
torch.save({"snaps": runs["ranks"], "witness": runs["witness"],
            "own_rows": {k: float(v) for k, v in m.items()}}, f"{out}/s2_rank{rank}.pt")
mesh.destroy()
if rank == 0:  # one process on the batch of both clips
    grid = None
    tr, state = build()
    one = []
    for _ in range(2):
        state, m = tr.train_step(state, *(torch.from_numpy(d[k]) for k in ("lq", "gt", "lat")))
        one.append({"metrics": {k: float(v) for k, v in m.items()}, "disc": clone(state.disc),
                    "opt_g": clone(state.opt_g), "opt_d": clone(state.opt_d)})
    torch.save(one, f"{out}/s2_one_process.pt")
"""


@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    """Two gloo ranks of the stage-2 trainer (VAE ch 32, 3 frames a clip,
    32x32, grad_accum 2, disc_start 0), two micro-steps, against the JAX
    step on the 2-clip batch; and the divisor witness."""
    tmp = tmp_path_factory.mktemp("s2")
    jcfg = tiny_config(num_frames=T, ddpm_steps=2)
    cfg = port_config(jcfg)
    pipe = MGLDVSRPipeline(cfg, device="cpu")
    init_pipeline_weights(pipe, 0)
    jitter_weights(pipe, 0.02, 0)
    from mgldvsr_tpu.io import ckpt_convert

    v = jcfg.vae
    jvae = ckpt_convert.convert_autoencoder(
        {k: t.numpy() for k, t in pipe.vae.state_dict().items()}, prefix="", video=True,
        fusion=True, ch_mult=v.ch_mult, num_res_blocks=v.num_res_blocks,
        attn_resolutions=v.attn_resolutions, resolution=v.resolution)
    s2cfg = dict(num_frames=T, grad_accum=2, disc_start=0)
    jtr = jstage2.Stage2Trainer(jcfg.vae, jstage2.Stage2Config(**s2cfg))
    state0 = jtr.init_state(jax.random.PRNGKey(0), SIZE, SIZE,
                            vae_params=jax.tree_util.tree_map(jnp.asarray, jvae))
    state0 = state0._replace(aux={**state0.aux, "spynet": jax.tree_util.tree_map(
        jnp.asarray, _calm_spynet(state0.aux["spynet"]))})
    state0 = jax.device_get(state0)
    data = {"lq": np.concatenate([_rand((T, SIZE, SIZE, 3), 10 + r) for r in range(D)]),
            "gt": np.concatenate([_rand((T, SIZE, SIZE, 3), 20 + r) for r in range(D)]),
            "lat": np.concatenate([np.random.RandomState(30 + r).randn(
                T, SIZE // 8, SIZE // 8, 4).astype(np.float32) for r in range(D)])}
    # the witness's latents: moved by 1e-6 relative, as test_torch_stage2's
    rs = np.random.RandomState(1)
    moved = (data["lat"] * (1 + 1e-6 * rs.randn(*data["lat"].shape))).astype(np.float32)
    np.savez(tmp / "data.npz", lat_moved=moved, **data)
    tr = pstage2.Stage2Trainer(VideoAutoencoderKLResi(cfg.vae), pstage2.Stage2Config(**s2cfg))
    start = from_jax.stage2_state_from_jax(state0, tr)
    CheckpointManager(str(tmp / "ckpt")).save(0, start)
    torch.save({"cfg": cfg, "s2cfg": s2cfg, "vae": tr.vae.state_dict(),
                "lpips": tr.lpips.state_dict(), "spynet": tr.spynet.state_dict()},
               tmp / "blob.pt")
    ranks = _in_background(run_ranks, tmp, _STAGE2_CHILD, D, timeout=400, blob=tmp / "blob.pt",
                           data=tmp / "data.npz", ckpt=tmp / "ckpt", t=T, min_out=MIN_OUT, tp=1)
    (tmp / "grid").mkdir()
    grid = _in_background(run_ranks, tmp / "grid", _STAGE2_CHILD, D * TP, timeout=400,
                          blob=tmp / "blob.pt", data=tmp / "data.npz", ckpt=tmp / "ckpt", t=T,
                          min_out=MIN_OUT, tp=TP)
    step = jax.jit(jtr.train_step)
    states, metrics, state = [state0], [], state0
    for _ in range(2):
        state, m = step(state, *(jnp.asarray(data[k]) for k in ("lq", "gt", "lat")),
                        jax.random.PRNGKey(1))
        states.append(jax.device_get(state))
        metrics.append(jax.device_get(m))
    ranks.result()
    grid.result()
    return dict(cfg=cfg, states=states, metrics=metrics,
                got=[_load(tmp, f"s2_rank{r}.pt") for r in range(D)], start=start,
                one_process=_load(tmp, "s2_one_process.pt"),
                grid=[_load(tmp / "grid", f"s2_grid_rank{r}.pt") for r in range(D * TP)])


def test_stage2_ranks_equal_one_process_on_the_batch(stage2):
    """The two ranks against the port in one process on the 2-clip batch:
    the same math in another order (the divisors, the adaptive weight and
    the batch statistics are the whole batch's in both). Micro-step 1: the
    metrics within 1e-6 relative (1e-6 of the logits' scale for the GAN
    terms), gradient leaves within 1e-5 of their max plus 1e-6 of the
    largest, the running statistics within 1e-6 [readings: 2e-7 relative,
    1.8e-6 of a discriminator leaf's max, 1.2e-7]. Micro-step 2 (the
    update): both optimisers' moments within 1e-4 of each leaf's max
    [1e-5 on a temporal blend scalar]."""
    one = stage2["one_process"][0]
    got = stage2["got"][0]["snaps"][0]
    scale = abs(one["metrics"]["logits_real"]) + abs(one["metrics"]["logits_fake"])
    for name, w in one["metrics"].items():
        floor = scale if name in ("g_loss", "logits_fake", "logits_real") else abs(w)
        assert abs(got["metrics"][name] - w) <= 1e-6 * max(abs(w), floor), name
    for part in ("opt_g", "opt_d"):
        _assert_leaves_close(got[part]["acc"], one[part]["acc"], 1e-5)
    for k, v in one["disc"].items():
        if "running" in k:
            assert float((got["disc"][k] - v).abs().max()) <= 1e-6, k
    one, got = stage2["one_process"][1], stage2["got"][0]["snaps"][1]
    for part in ("opt_g", "opt_d"):
        for moment in ("mu", "nu"):
            _assert_leaves_close(got[part][moment], one[part][moment], 1e-4)


def _stage2_ranks(stage2, who):
    """Every rank's snapshots: the two data-parallel ranks, or the 2 x 2
    grid's four (each saved its state gathered)."""
    return [r["snaps"] for r in (stage2["got"] if who == "ranks" else stage2["grid"])]


@pytest.mark.parametrize("who", ["ranks", "grid"])
@pytest.mark.parametrize("micro_step", [1, 2])
def test_stage2_two_ranks_metrics_match_jax(stage2, micro_step, who):
    """nll_loss and d_weight among them: the whole batch's rows divide the
    NLL, and the adaptive weight is the norms' ratio of the group's
    last-layer gradients. ``grid``: the two clips on a 2 x 2 grid, the VAE,
    LPIPS, the discriminator and SpyNet split by the tensor rule at
    ``MIN_OUT``."""
    want = stage2["metrics"][micro_step - 1]
    scale = abs(float(want["logits_real"])) + abs(float(want["logits_fake"]))
    for snaps in _stage2_ranks(stage2, who):
        got = snaps[micro_step - 1]["metrics"]
        for name in ("loss_g", "nll_loss", "rec_loss", "temp_loss", "g_loss", "d_weight",
                     "loss_d", "logits_real", "logits_fake"):
            w = float(want[name])
            floor = scale if name in ("g_loss", "logits_fake", "logits_real") else abs(w)
            assert abs(got[name] - w) <= 1e-5 * max(abs(w), floor), (name, got[name], w)
    assert got["d_weight"] > 0 and got["temp_loss"] > 0


def test_stage2_dividing_by_a_rank_s_own_rows_misses_d_weight_twice(stage2):
    """The witness of the first trap: each rank dividing the NLL and
    frame-difference terms by its own rows makes the NLL's last-layer
    gradient, and so d_weight, 2x the JAX step's (and nll_loss 2x)."""
    want = stage2["metrics"][0]
    wit = stage2["got"][0]["own_rows"]
    assert wit["d_weight"] / float(want["d_weight"]) == pytest.approx(2.0, rel=1e-4)
    assert wit["nll_loss"] / float(want["nll_loss"]) == pytest.approx(2.0, rel=1e-4)


@pytest.mark.parametrize("who", ["ranks", "grid"])
def test_stage2_two_ranks_gradients_statistics_and_updates_match_jax(stage2, who):
    """Micro-step 1: the generator's and the discriminator's accumulated
    gradients (the whole batch's), the running statistics; micro-step 2:
    the statistics, the trainables, logvar and the discriminator after the
    update, both Adam states; every rank holds the same. The grid against
    the data-parallel ranks' witness."""
    j1, j2 = stage2["states"][1], stage2["states"][2]
    ranks = _stage2_ranks(stage2, who)
    r0, w0 = ranks[0], stage2["got"][0]["witness"]
    grads_g = _gen_names(j1.opt_g.acc_grads, stage2)
    one = stage2["one_process"][0]["opt_g"]["acc"]
    top = max(float(w.abs().max()) for w in grads_g.values())
    for k, w in grads_g.items():  # or 1.5x as far as the port in one process stands
        tol = max(3e-4 * float(w.abs().max()) + 1e-6 * top,
                  1.5 * float((one[k] - w).abs().max()))
        assert float((r0[0]["opt_g"]["acc"][k] - w).abs().max()) <= tol, k
    _assert_leaves_close(r0[0]["opt_d"]["acc"], _disc_names(j1.opt_d.acc_grads, stage2), 1e-4,
                         witness=w0[0]["opt_d"]["acc"])
    for snap, j in ((r0[0], j1), (r0[1], j2)):
        want = from_jax.discriminator_state_dict(numpy_tree(j.disc))
        for k, w in want.items():
            if "running" in k:
                assert float((snap["disc"][k] - w).abs().max()) <= 1e-6, k
    got = {**r0[1]["trainable"], "logvar": r0[1]["logvar"]}
    _assert_after_adam(got, _gen_names((j2.gen_trainable, j2.logvar), stage2), grads_g)
    params = {k: v for k, v in r0[1]["disc"].items() if "running" not in k}
    _assert_after_adam(params, _disc_names(j2.disc["params"], stage2),
                       _disc_names(j1.opt_d.acc_grads, stage2))
    adam_g = from_jax._find(j2.opt_g, ("count", "mu", "nu"))
    adam_d = from_jax._find(j2.opt_d, ("count", "mu", "nu"))
    for moment in ("mu", "nu"):
        _assert_leaves_close(r0[1]["opt_d"][moment], _disc_names(getattr(adam_d, moment), stage2),
                             1e-4, witness=w0[1]["opt_d"][moment])
    assert r0[1]["opt_g"]["count"] == r0[1]["opt_d"]["count"] == int(adam_g.count) == 1
    for other in ranks[1:]:
        for part in ("trainable", "disc"):
            assert all(torch.equal(other[1][part][k], v) for k, v in r0[1][part].items()), part


def test_stage2_grid_splits_every_network_by_the_jax_rule(stage2, monkeypatch):
    """The 2 x 2 grid split a share of the VAE's trainables and of the
    discriminator; and at the loss networks' real widths (LPIPS' VGG16, the
    PatchGAN, SpyNet) with the rule's own threshold, the port splits
    exactly the leaves that the JAX package's ``_param_spec`` splits in the
    JAX stage-2 state (``aux`` and ``disc``), at T = 2 and 4, along the
    torch axis of the flax kernel's last one."""
    grid = stage2["grid"][0]
    axes = grid["tensor_axes"]
    start = stage2["start"]
    assert 0 < sum(k in axes for k in start.trainable) < len(start.trainable)
    assert 0 < sum(k in axes for k in start.disc) < len(start.disc)
    assert all(grid["modules"].values())
    tr = pstage2.Stage2Trainer(VideoAutoencoderKLResi(stage2["cfg"].vae))
    state0 = stage2["states"][0]
    trees = {"lpips": state0.aux["lpips"], "spynet": state0.aux["spynet"],
             "disc": {"params": state0.disc["params"]}}
    for tp in (2, 4):
        for name, tree in trees.items():
            module = tr.modules()[name]
            paths = from_jax.jax_paths(name, module)
            by_path = {p[1:]: (k, axis) for k, (p, axis) in paths.items()}
            want = {}
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                keys = tuple(e.key for e in path)
                keys = keys[1:] if keys[0] == "params" and name != "disc" else keys
                torch_key, axis = by_path[keys]
                spec = tuple(jmesh._param_spec(tuple(str(e) for e in path), leaf, tp))
                if "tensor" in spec:
                    want[torch_key] = axis % module.state_dict()[torch_key].ndim
                assert np.prod(leaf.shape) == module.state_dict()[torch_key].numel()
            got = mesh.tensor_axes(name, module, tp)
            assert got == want, (name, tp)
            assert want or name == "spynet", name


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

_CLI_CHILD = r"""
from mgldvsr_tpu_torch.cli import train as cli
mesh.ZERO1_MIN_SIZE = int(args["min_size"])
mesh.TENSOR_MIN_OUT = int(args.get("min_out", mesh.TENSOR_MIN_OUT))
cli.main(["--stage", "1", "--data-root", args["data"], "--tiny", "--device", "cpu",
          "--max-steps", args["steps"], "--grad-accum", "2", "--ckpt-every", "2",
          "--log-every", "1", "--no-tb", "--logdir", args["logdir"], "--mesh",
          "--init-method", args["init"]] + args.get("flags", "--zero1").split(",")
         + (["--resume"] if args["resume"] == "1" else []))
"""


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("gt")
    rs = np.random.RandomState(0)
    for clip in ("001", "002", "003"):
        os.makedirs(root / clip)
        for i in range(6):
            write_frame(str(root / clip / f"{i:08d}.png"),
                        (rs.rand(40, 48, 3) * 255).astype(np.uint8))
    return str(root)


def test_cli_mesh_zero1_in_two_ranks_saves_whole_and_resumes(data_root, tmp_path, capsys):
    """``cli.train --tiny --mesh --zero1 --device cpu`` in two gloo ranks:
    one metrics.jsonl, written by rank 0, a record a step; checkpoints of
    the whole state (full-size moments and shadows). Two ranks resuming the
    step-2 checkpoint replay steps 3-4 bit for bit (each rank's data shard
    and draws continue), and one process without ``--mesh`` resumes the
    step-4 checkpoint and goes on."""
    a, b = tmp_path / "a", tmp_path / "b"
    for runs in ("ra", "rb"):
        (tmp_path / runs).mkdir()
    run_ranks(tmp_path / "ra", _CLI_CHILD, D, timeout=300, data=data_root, logdir=a, steps=4,
              resume=0, min_size=MIN_SIZE)
    records = [json.loads(line) for line in open(a / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in records)
    mgr = CheckpointManager(str(a / "ckpt"))
    assert mgr.all_steps() == [2, 4]
    saved = mgr.restore(4)
    sizes = {k: v.shape for k, v in saved["trainable"].items()}
    assert any(mesh.zero1_spec(s, D, MIN_SIZE) is not None for s in sizes.values())
    for part in ("mu", "nu"):
        assert {k: v.shape for k, v in saved["opt_state"][part].items()} == sizes
    assert {k: v.shape for k, v in saved["ema"].items()} == sizes
    os.makedirs(b / "ckpt")
    os.rename(a / "ckpt" / "2", b / "ckpt" / "2")
    run_ranks(tmp_path / "rb", _CLI_CHILD, D, timeout=300, data=data_root, logdir=b, steps=4,
              resume=1, min_size=MIN_SIZE)
    assert "resumed at step 2" in (tmp_path / "rb" / "rank1.log").read_text()
    replay = CheckpointManager(str(b / "ckpt")).restore(4)
    for part in ("trainable", "ema"):
        assert all(torch.equal(saved[part][k], replay[part][k]) for k in saved[part]), part
    for part in ("mu", "nu"):
        assert all(torch.equal(saved["opt_state"][part][k], replay["opt_state"][part][k])
                   for k in saved["opt_state"][part]), part
    cli.main(["--stage", "1", "--data-root", data_root, "--tiny", "--device", "cpu",
              "--max-steps", "6", "--grad-accum", "2", "--ckpt-every", "2", "--log-every", "1",
              "--no-tb", "--logdir", str(a), "--resume"])
    assert "resumed at step 4" in capsys.readouterr().out
    assert CheckpointManager(str(a / "ckpt")).all_steps() == [4, 6]


def test_cli_mesh_in_a_world_of_one_is_the_run_without_it(data_root, tmp_path):
    """One gloo rank with ``--mesh --zero1 --tensor-parallel 1`` writes the
    checkpoint and the losses of the command without the flags, bit for
    bit: every collective of a world of one leaves its tensors as they
    were."""
    (tmp_path / "r").mkdir()
    run_ranks(tmp_path / "r", _CLI_CHILD, 1, timeout=300, data=data_root, logdir=tmp_path / "a",
              steps=2, resume=0, min_size=MIN_SIZE, flags="--zero1,--tensor-parallel,1")
    assert "mesh {'data': 1, 'tensor': 1} over 1 devices" in (
        tmp_path / "r" / "rank0.log").read_text()
    cli.main(["--stage", "1", "--data-root", data_root, "--tiny", "--device", "cpu",
              "--max-steps", "2", "--grad-accum", "2", "--ckpt-every", "2", "--log-every", "1",
              "--no-tb", "--logdir", str(tmp_path / "b")])
    a, b = (CheckpointManager(str(tmp_path / d / "ckpt")).restore(2) for d in ("a", "b"))
    for part in ("trainable", "ema"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part
    for part in ("mu", "nu", "acc"):
        assert all(torch.equal(a["opt_state"][part][k], b["opt_state"][part][k])
                   for k in a["opt_state"][part]), part
    losses = [[json.loads(line)["loss"] for line in open(tmp_path / d / "metrics.jsonl")]
              for d in ("a", "b")]
    assert losses[0] == losses[1]


def test_cli_tensor_parallel_in_two_ranks_saves_whole_and_resumes_without_mesh(
        data_root, tmp_path, capsys):
    """``--mesh --tensor-parallel 2 --zero1`` in two gloo ranks (a 1 x 2
    grid, the tiny towers split at ``MIN_OUT``) prints the mesh, logs every
    step and checkpoints the whole state in the single-process layout; the
    command without ``--mesh`` resumes its step-4 checkpoint with the same
    masters, EMA and moments, and trains on."""
    (tmp_path / "r").mkdir()
    logdir = tmp_path / "a"
    run_ranks(tmp_path / "r", _CLI_CHILD, 2, timeout=300, data=data_root, logdir=logdir, steps=4,
              resume=0, min_size=MIN_SIZE, min_out=MIN_OUT, flags="--zero1,--tensor-parallel,2")
    for r in range(2):
        log = (tmp_path / "r" / f"rank{r}.log").read_text()
        assert "mesh {'data': 1, 'tensor': 2} over 2 devices, host 0/1" in log
    assert [json.loads(line)["step"] for line in open(logdir / "metrics.jsonl")] == [1, 2, 3, 4]
    saved = CheckpointManager(str(logdir / "ckpt")).restore(4)
    argv = ["--stage", "1", "--data-root", data_root, "--tiny", "--device", "cpu",
            "--grad-accum", "2", "--ckpt-every", "2", "--log-every", "1", "--no-tb",
            "--logdir", str(logdir), "--resume"]
    resumed = cli.stage1(cli.parse_args(argv + ["--max-steps", "4"]))
    assert "resumed at step 4" in capsys.readouterr().out
    for part in ("trainable", "ema"):
        got = getattr(resumed, part)
        assert set(got) == set(saved[part])
        assert all(torch.equal(got[k], v) for k, v in saved[part].items()), part
    for part in ("mu", "nu"):
        assert all(torch.equal(resumed.opt_state[part][k], v)
                   for k, v in saved["opt_state"][part].items()), part
    cli.stage1(cli.parse_args(argv + ["--max-steps", "6"]))
    assert CheckpointManager(str(logdir / "ckpt")).all_steps() == [2, 4, 6]


_CHECK_CHILD = r"""
import argparse, datetime, json
from mgldvsr_tpu_torch.parallel import tensor
from mgldvsr_tpu_torch.tools import multicard_train_check as tool
from mgldvsr_tpu_torch.utils.precision import tf32_off
if args["fault"] == "unsummed":  # each rank keeps its own part of a split layer's input gradient
    tensor._CopyToGroup.backward = staticmethod(lambda ctx, *grads: (None, *grads))
tool._timings = lambda *a, **k: None  # check (a) alone: (c) times it
ns = argparse.Namespace(preset="tiny", seed=0, steps=2, timed=0, tower_dtype=args["dtype"],
                        peak_tp=[])
mesh.TENSOR_MIN_OUT = int(args["min_out"])
report = {}
with tf32_off():
    ok = tool._stage1(ns, mesh.init_group("cpu", args["init"],
                                          timeout=datetime.timedelta(seconds=90)),
                      mesh.init_grid(2), report)
if rank == 0:
    open(f"{out}/report.json", "w").write(json.dumps({"ok": ok, **report}, default=str))
mesh.destroy()
"""

CHECK_RUNS = {"bfloat16": ("bfloat16", ""), "float32": ("float32", ""),
              "bfloat16_unsummed": ("bfloat16", "unsummed")}


@pytest.fixture(scope="module")
def tensor_check(tmp_path_factory):
    """``tools/multicard_train_check.py``'s check (a) on a 1 x 2 grid of
    gloo ranks (the tiny towers split at ``MIN_OUT``), with bf16 and with
    float32 towers, and a bf16 grid whose split layers keep each rank's own
    part of their input gradient (the tensor group's sum left out), the
    three grids at once."""
    tmp = tmp_path_factory.mktemp("check")
    runs = {}
    for name, (dtype, fault) in CHECK_RUNS.items():
        (tmp / name).mkdir()
        runs[name] = _in_background(run_ranks, tmp / name, _CHECK_CHILD, 2, timeout=200,
                                    dtype=dtype, fault=fault, min_out=MIN_OUT)
    for future in runs.values():
        future.result()
    return {name: json.loads((tmp / name / "report.json").read_text()) for name in runs}


@pytest.mark.parametrize("name", list(CHECK_RUNS))
def test_tensor_parallel_check_holds_a_grid_to_its_bound(tensor_check, name):
    """A bf16 grid is held to the float32 one process: its loss, worst leaf
    and whole gradient each within ``BF16_GRID_K`` (2) times the one bf16
    process's own distance from float32; and by the same measures within
    ``BF16_GRID_TO_ONE`` (1) times that distance of the one bf16 process
    (measured: loss 6.0e-5, leaf 0.95, whole 0.050 against 3.8e-3, 2.05 and
    0.437). Its loss stands within 1e-4 of the one bf16 process's (each rank
    adds its rows of a split layer's bias inside the layer: 4.0e-3 when the
    bias was added after the gather). A float32 grid holds the data-parallel
    limits (loss within 1e-5, each leaf within 3e-4 of its max). Either way
    the masters are equal on both ranks before and after every micro-step,
    replicated and with ZeRO-1. A bf16 grid that leaves out the tensor
    group's sum of the input gradient fails both bounds (measured: whole
    0.97 from the one bf16 process, 0.97 from float32)."""
    from mgldvsr_tpu_torch.tools.multicard_train_check import BF16_GRID_K, BF16_GRID_TO_ONE

    report = tensor_check[name]
    dtype, fault = CHECK_RUNS[name]
    assert report["ok"] == (not fault)
    assert BF16_GRID_K == 2.0 and BF16_GRID_TO_ONE == 1.0
    for row_name in ("replicated", "zero1"):
        row = report["stage1"][row_name]
        assert row["tensor_split_trainables"] > 0
        assert row["masters_max_abs_diff_every_step"] == [0.0, 0.0, 0.0]
        if dtype == "float32":
            assert row["leaves_held"] and row["loss_rel"] <= 1e-5
            assert "from_float32" not in row
            continue
        own = report["one_bf16_process_from_float32"]
        for k, v in own.items():
            assert row["bound_from_float32"][k] == BF16_GRID_K * v
            assert row["bound_from_one_process"][k] == BF16_GRID_TO_ONE * v
        if fault:
            assert not row["held_to_float32"] and not row["held_to_one_process"]
            assert row["from_one_process"]["whole"] > own["whole"]
            assert row["from_float32"]["whole"] > BF16_GRID_K * own["whole"]
            continue
        assert row["held_to_float32"] and row["held_to_one_process"]
        for k, v in row["from_float32"].items():
            assert v <= BF16_GRID_K * own[k], k
        for k, v in row["from_one_process"].items():
            assert v <= BF16_GRID_TO_ONE * own[k], k
        assert row["loss_rel"] <= 1e-4


_STAGE2_CLI_CHILD = r"""
from mgldvsr_tpu_torch.cli import train as cli
mesh.TENSOR_MIN_OUT = int(args["min_out"])
cli.main(args["argv"].split(",") + ["--mesh", "--tensor-parallel", "2", "--zero1",
                                    "--init-method", args["init"], "--no-tb"])
"""


def test_cli_stage2_on_a_one_by_two_grid_saves_and_exports_whole(roots, tmp_path):
    """``--stage 2 --mesh --tensor-parallel 2 --zero1`` in two gloo ranks
    (the tiny VAE, LPIPS and the discriminator split at ``MIN_OUT``): finite
    metrics every step, a checkpoint in the single-process layout (every
    tensor shaped as the run without ``--mesh`` shapes it) and an exported
    VAE whose frozen parameters equal that run's bit for bit (gathered from
    the ranks' rows)."""
    (tmp_path / "r").mkdir()
    grid_dir, plain_dir = tmp_path / "grid", tmp_path / "plain"
    run_ranks(tmp_path / "r", _STAGE2_CLI_CHILD, 2, timeout=300, min_out=MIN_OUT,
              argv=",".join(_stage2_argv(roots, grid_dir, 2)))
    cli.main(_stage2_argv(roots, plain_dir, 2, "--no-tb"))
    records = [json.loads(line) for line in open(grid_dir / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[k]) for r in records for k in ("loss_g", "loss_d", "d_weight"))
    got, want = (CheckpointManager(str(d / "ckpt")).restore(2) for d in (grid_dir, plain_dir))

    def shapes(tree):
        if isinstance(tree, torch.Tensor):
            return tuple(tree.shape)
        return {k: shapes(v) for k, v in tree.items()} if isinstance(tree, dict) else None

    for part in ("trainable", "disc", "opt_g", "opt_d"):
        assert shapes(got[part]) == shapes(want[part]), part
    vae = {d: _load(d / "export", "vqgan.pt")["state_dict"] for d in (grid_dir, plain_dir)}
    assert vae[grid_dir].keys() == vae[plain_dir].keys()
    frozen = [k for k in vae[plain_dir] if k not in want["trainable"]]
    assert all(torch.equal(vae[grid_dir][k], vae[plain_dir][k]) for k in frozen)
    assert "mesh {'data': 1, 'tensor': 2}" in (tmp_path / "r" / "rank0.log").read_text()


def test_cli_three_ranks_degrade_tensor_parallel_2_to_1(data_root, tmp_path):
    """Three ranks cannot hold a tensor axis of 2: the grid degrades to 3 x
    1, as JAX's ``make_mesh`` does, every rank prints it, and the run trains
    data-parallel."""
    (tmp_path / "r").mkdir()
    run_ranks(tmp_path / "r", _CLI_CHILD, 3, timeout=300, data=data_root, logdir=tmp_path / "a",
              steps=2, resume=0, min_size=MIN_SIZE, flags="--tensor-parallel,2")
    for r in range(3):
        log = (tmp_path / "r" / f"rank{r}.log").read_text()
        assert "mesh {'data': 3, 'tensor': 1} over 3 devices, host 0/1" in log, log[-2000:]
    records = [json.loads(line) for line in open(tmp_path / "a" / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2] and all(np.isfinite(r["loss"]) for r in records)


def test_tensor_parallel_flag(data_root, capsys):
    """``--tensor-parallel 1`` (JAX's default) is accepted with and without
    ``--mesh``; a tensor axis above 1 needs ``--mesh``, and below 1 is
    refused."""
    base = ["--data-root", data_root, "--device", "cpu"]
    assert cli.parse_args(base + ["--tensor-parallel", "1"]).tensor_parallel == 1
    assert cli.parse_args(base + ["--mesh", "--tensor-parallel", "4"]).tensor_parallel == 4
    for bad in (["--tensor-parallel", "2"], ["--mesh", "--tensor-parallel", "0"]):
        with pytest.raises(SystemExit):
            cli.parse_args(base + bad)
        assert "--tensor-parallel" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--mesh"], ["--multihost"], ["--zero1", "--mesh"]])
def test_parallel_flags_need_a_process_group(data_root, tmp_path, monkeypatch, flags):
    """Without RANK and WORLD_SIZE (no torchrun) the command line stops with
    ``init_group``'s message before it trains; ``--multihost`` implies
    ``--mesh``."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--data-root", data_root, "--tiny", "--device", "cpu", "--logdir", str(tmp_path),
            *flags]
    assert cli.parse_args(argv).mesh
    with pytest.raises(RuntimeError, match="init_group: RANK is not set"):
        cli.main(argv)
    assert not os.listdir(tmp_path)

"""Training across ranks, data-parallel or on a (data x tensor) grid, held
against one process.

  torchrun --nproc_per_node=N -m mgldvsr_tpu_torch.tools.multicard_train_check \\
      [--tensor-parallel T] [--peak-tp 1,2,4] [--tensor-min-out 256] \\
      [--device cuda|cpu] [--preset full|tiny] [--steps 4] [--timed 6] [--seed 0] \\
      [--init-method file:///PATH] [--timeout 600]

The N ranks form ``mesh.init_grid(T)``: D = N / T data indices of T ranks
(T degraded as the training command line degrades it). Every rank builds the
same seeded pipeline (weights jittered by 0.02 N(0,1), so that the temporal
convs get a gradient); each data index trains on a clip of its own: a seeded
moving pattern, its LQ the bicubic x1/4 of the GT brought back up, one clip a
data index a micro-step, the draws seeded from the seed, the step and the
data index (``cli.train.step_seed``). With T > 1 the towers are split by the
JAX rule (``--tensor-min-out`` lowers its width, to split the tiny preset).

(a) Stage 1 at the preset's widths (full: the shipped UNet and struct-cond,
    bf16 towers, float32 masters, GT 512, 5 frames), replicated and then
    with ZeRO-1, ``--steps`` micro-steps at grad_accum 2. Before the first
    and after every micro-step every rank's masters (gathered from the
    tensor slices) equal rank 0's bit for bit. After micro-step 1, rank 0's
    averaged gradient (the accumulator, gathered) and the group's loss
    against one process on rank 0's card (a pipeline of its own, unsplit)
    that takes the D clips one after another, with the same draws, and
    averages their gradients (stage 1 couples no clips, so that is the
    D-clip batch's gradient): the loss within 1e-5 relative, each gradient
    leaf within 3e-4 of its max |g| plus 1e-6 of the largest
    (``tests/test_torch_train``).
(b) Stage 2 at tiny widths (VAE ch 32, 5 frames of 64x64, float32, grad_accum
    2, disc_start 0, SpyNet's last convs x1e-2; with T > 1 LPIPS and the
    discriminator split at their real widths), two micro-steps of the grid
    against one process on rank 0's card that takes the D clips as one
    batch: phase 9 (a)'s limits in ``chip_smoke.py`` (the metrics, each
    gradient leaf's distance over its norm plus 1e-3 of the largest leaf
    norm and the whole gradient's over its norm, for the generator and the
    discriminator, the running statistics relative to their largest value).
(c) Times (stage 1, after (a)): ``--timed`` micro-steps on every rank at
    once against as many on rank 0 alone (no group) on its clip and, with
    T > 1, on D data-parallel ranks (the first D ranks, the others idle):
    clips/s of each; the gradient reduction alone on a micro-step's
    gradient, replicated (all-reduce) and ZeRO-1 (reduce-scatter), and
    ZeRO-1's all-gather of the masters; with T > 1 one micro-step's
    activation all-gathers and input-gradient all-reduces over the tensor
    group, replayed alone: count, bytes and ms (the devices synchronised,
    the median of five); each rank's peak device memory in (a), replicated
    and with ZeRO-1, and rank 0's kernel launches in micro-step 2.
(d) With ``--peak-tp``: each rank's peak device memory over two micro-steps
    at each other tensor axis listed that divides N, replicated and with
    ZeRO-1 (a pipeline built for each).

Rank 0 prints one JSON line and exits 1 when a check fails.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

# chip_smoke.py phase 9 (a)'s limits: the metrics relative (the GAN means of
# logits against the logits' scale), a leaf's distance over its norm plus
# 1e-3 of the largest leaf norm, the whole gradient's over its norm, and the
# running statistics relative to their largest value
S2_METRIC_REL = 3.5e-5
S2_LEAF = {"gen": 3e-3, "disc": 3e-5}
S2_WHOLE = {"gen": 2.5e-4, "disc": 1.7e-5}
S2_STATS_REL = 1e-6
S2_METRICS = ("loss_g", "nll_loss", "rec_loss", "temp_loss", "g_loss", "d_weight", "loss_d",
              "logits_real", "logits_fake")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _clip(seed: int, size: int, frames: int, device):
    """(lq upscaled to size, gt) [frames, size, size, 3] in [0, 1]."""
    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
    from mgldvsr_tpu_torch.ops.resize import resize2d
    from mgldvsr_tpu_torch.tools.multicard_check import moving_clip

    gt = torch.from_numpy(moving_clip(seed, size, frames))
    lq = resize2d(gt, (size // 4, size // 4), method="bicubic").clamp(0, 1)
    return upscale_frames(lq.to(device), 4), gt.to(device)


def _pipeline(preset: str, seed: int, device):
    """The seeded, jittered pipeline with float32 weights (the trainers
    cast the towers): the shipped widths with bf16 towers on the card, or
    the tiny ones in float32."""
    from mgldvsr_tpu_torch.cli import train as cli
    from mgldvsr_tpu_torch.cli.infer import tiny_pipeline_config
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights, jitter_weights

    if preset == "tiny":
        pipe = MGLDVSRPipeline(tiny_pipeline_config(torch.float32, num_frames=5), device=device)
        init_pipeline_weights(pipe, seed)
    else:
        pipe = cli.build_pipeline(argparse.Namespace(tiny=False, device=str(device),
                                                     num_frames=5, cfg={}, torch_ckpt=None,
                                                     seed=seed))
    jitter_weights(pipe, 0.02, seed)
    return pipe


def _whole_masters(trainer, state) -> dict:
    """The masters whole: gathered from the tensor slices (collective)."""
    tensor = trainer.zero.tensor
    return state.trainable if tensor is None else tensor.gather(state.trainable)


def _masters_apart(masters: dict, device) -> float:
    """The largest |difference| between a rank's (whole) masters and rank
    0's, over the ranks (0.0: every rank holds rank 0's bit for bit)."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in masters.values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    worst = (flat - ref).abs().max().reshape(1)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return float(worst.item())


def _fresh_state(trainer, masters0: dict):
    """A start state from the float32 masters ``masters0`` (copied onto the
    trainer's device), the towers loaded, cut to this rank's (the towers
    split on the grid)."""
    from mgldvsr_tpu_torch.train import optim
    from mgldvsr_tpu_torch.train.trainer import TrainState, partition_params

    masters = {k: v.to(trainer.device, copy=True) for k, v in masters0.items()}
    _, frozen = partition_params(trainer.pipe)
    state = TrainState(trainable=masters, frozen=frozen,
                       opt_state=optim.init_opt_state(masters, trainer.opt_cfg),
                       ema={k: v.clone() for k, v in masters.items()}, step=0)
    trainer.load_towers(state)
    return trainer.shard(state)


def _peak_gib(device):
    return torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _stage1(args, device, grid, report) -> bool:
    """(a), (c) and (d). Rank 0's one-process reference and its timing run
    first, on a pipeline of their own that is freed before the ranks train:
    every trainer then builds its own pipeline, so that each peak holds one
    pipeline and one state."""
    from mgldvsr_tpu_torch.cli.train import step_seed
    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.parallel import mesh
    from mgldvsr_tpu_torch.train.trainer import Stage1Config, Stage1Trainer

    rank, world = mesh.rank(), mesh.world()
    size = 512 if args.preset == "full" else 32
    cfg = Stage1Config(grad_accum=2)
    plain = Stage1Trainer(_pipeline(args.preset, args.seed, device), cfg)
    masters0 = {k: v.cpu() for k, v in plain.init_state().trainable.items()}
    clips = [_clip(args.seed + 10 + d, size, 5, device) for d in range(grid.dp)]
    n, h = 5, size // 8

    def draws(trainer, step, d):
        gen = torch.Generator(device=device).manual_seed(step_seed(args.seed, step, d))
        return trainer.draws(n, h, h, gen)

    def trainer_on(g, zero1):
        pipe = _pipeline(args.preset, args.seed, device)
        pipe.cast_to_compute_dtypes()  # as init_state casts the reference's
        return Stage1Trainer(pipe, cfg, grid=g, zero1=zero1)

    # rank 0 alone: the D clips one after another, their gradients averaged;
    # then its own clip's micro-steps timed
    ref, alone_s = None, None
    if rank == 0:
        state = _fresh_state(plain, masters0)
        total, losses = None, []
        for d, (lq, gt) in enumerate(clips):
            loss, _, grads = plain.loss_and_grads(lq, gt, draws(plain, 0, d))
            losses.append(float(loss))
            total = grads if total is None else {k: total[k] + g for k, g in grads.items()}
        ref = {"loss": float(np.mean(losses)),
               "grad": {k: (g / grid.dp).cpu() for k, g in total.items()}}
        del total, grads
        lq, gt = clips[0]
        state, _ = plain.train_step(state, lq, gt, draws=draws(plain, 0, 0))  # warm
        _sync(device)
        t0 = time.perf_counter()
        for step in range(args.timed):
            state, _ = plain.train_step(state, lq, gt, draws=draws(plain, 100 + step, 0))
        _sync(device)
        alone_s = time.perf_counter() - t0
        del state
    del plain
    _reset_peak(device)
    mesh.barrier()

    out, ok = {}, True
    lq, gt = clips[grid.data_index]
    for name, zero1 in (("replicated", False), ("zero1", True)):
        trainer = trainer_on(grid, zero1)
        state = _fresh_state(trainer, masters0)
        _reset_peak(device)
        apart = [_masters_apart(_whole_masters(trainer, state), device)]
        step_s, launches = [], None
        for step in range(args.steps):
            _sync(device)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, lq, gt,
                                                draws=draws(trainer, step, grid.data_index))
            _sync(device)
            step_s.append(time.perf_counter() - t0)
            if step == 1:  # a rank's kernel launches in a micro-step (the second: warm)
                launches = {k: v for k, v in kernels.launch_counts().items() if v}
            apart.append(_masters_apart(_whole_masters(trainer, state), device))
            if step == 0:
                # the accumulator holds the group's gradient; whole tensors on rank 0
                acc = trainer.gather(state).opt_state["acc"]
                loss = float(metrics["loss"])
                if rank == 0:
                    acc = {k: v.cpu() for k, v in acc.items()}
                    top = max(float(g.abs().max()) for g in ref["grad"].values())
                    leaf = max(float((acc[k] - g).abs().max()) / float(g.abs().max() + 1e-30)
                               for k, g in ref["grad"].items()
                               if float(g.abs().max()) >= 1e-4 * top)
                    held = all(float((acc[k] - g).abs().max())
                               <= 3e-4 * float(g.abs().max()) + 1e-6 * top
                               for k, g in ref["grad"].items())
                    loss_rel = abs(loss - ref["loss"]) / abs(ref["loss"])
                del acc
        peaks = [None] * world
        torch.distributed.all_gather_object(peaks, _peak_gib(device))
        tensor = trainer.zero.tensor
        out[name] = {"masters_max_abs_diff_every_step": apart, "peak_gib_by_rank": peaks,
                     "zero1_split_tensors": len(trainer.zero.axes),
                     "tensor_split_trainables": 0 if tensor is None else sum(
                         k in tensor.axes for k in masters0),
                     "step_s_rank0": step_s, "launches_rank0": launches}
        if rank == 0:
            out[name].update(loss_rel=loss_rel, worst_leaf=leaf, leaves_held=held)
            ok = ok and not any(apart) and held and loss_rel <= 1e-5
        if name == "replicated":
            timed = _timings(args, device, grid, trainer, state, masters0, clips, draws,
                             trainer_on, alone_s)
        del trainer, state
        _reset_peak(device)
    report["stage1"] = out
    report["timing"] = timed
    if args.peak_tp:
        report["peaks_by_tp"] = _peaks(args, device, grid, masters0, clips, draws, trainer_on)
    return ok


def _timed_steps(trainer, state, lq, gt, steps, draws, d, device, group=None) -> float:
    """Seconds of ``steps`` micro-steps after a warm one, every rank of
    ``group`` (the world by default) starting together."""
    from mgldvsr_tpu_torch.parallel import mesh

    state, _ = trainer.train_step(state, lq, gt, draws=draws(trainer, 99, d))  # warm
    _sync(device)
    mesh.barrier(group)
    t0 = time.perf_counter()
    for step in range(steps):
        state, _ = trainer.train_step(state, lq, gt, draws=draws(trainer, 100 + step, d))
    _sync(device)
    mesh.barrier(group)
    return time.perf_counter() - t0


def _timings(args, device, grid, trainer, state, masters0, clips, draws, trainer_on,
             alone_s) -> dict:
    """(c): the grid's micro-steps against rank 0's alone (and D
    data-parallel ranks'), the reduction alone, the tensor group's
    collectives alone."""
    import torch.distributed as dist

    from mgldvsr_tpu_torch.parallel import mesh, tensor
    from mgldvsr_tpu_torch.train import optim

    lq, gt = clips[grid.data_index]
    group_s = _timed_steps(trainer, state, lq, gt, args.timed, draws, grid.data_index, device)
    dp_s = None
    if grid.tp > 1:  # the D clips on D data-parallel ranks (the first D), the others idle
        sub = mesh.subgroup(grid.dp)
        if mesh.rank() < grid.dp:
            r = mesh.rank()
            dp = trainer_on(mesh.Grid(grid.dp, 1, r, 0, sub), False)
            dp_s = _timed_steps(dp, _fresh_state(dp, masters0), *clips[r], args.timed, draws, r,
                                device, sub)
            del dp
        mesh.barrier()
    tensor.gather_columns.shapes, tensor.copy_to_group.shapes = [], []
    _, _, grads = trainer.loss_and_grads(lq, gt, draws(trainer, 200, grid.data_index))
    gathers, sums = tensor.gather_columns.shapes, tensor.copy_to_group.shapes
    tensor.gather_columns.shapes = tensor.copy_to_group.shapes = None
    nbytes = sum(g.numel() * g.element_size() for g in grads.values())
    shapes = {k: g.shape for k, g in grads.items()}
    taxes = trainer.zero.tensor.axes if trainer.zero.tensor is not None else {}
    for k, axis in taxes.items():  # the whole shapes, as ZeroShard judges them
        if k in shapes:
            whole = list(shapes[k])
            whole[axis] *= grid.tp
            shapes[k] = torch.Size(whole)
    zero = mesh.ZeroShard(shapes, grid.data_group, zero1=True, tensor=trainer.zero.tensor)

    def median_ms(fn, group=None):
        times = []
        for _ in range(6):
            mesh.barrier(group)
            _sync(device)
            t0 = time.perf_counter()
            fn()
            _sync(device)
            times.append(1000 * (time.perf_counter() - t0))
        return float(np.median(times[1:]))

    masters = {k: v.clone() for k, v in state.trainable.items()}
    out = {"micro_steps": args.timed, "group_s": group_s, "alone_s_rank0": alone_s,
           "group_clips_per_s": grid.dp * args.timed / group_s,
           "alone_clips_per_s": args.timed / alone_s if alone_s else None,
           "gradient_bytes": nbytes,
           "all_reduce_ms": median_ms(lambda: trainer.zero.reduce_gradients(grads)),
           "reduce_scatter_ms": median_ms(lambda: zero.reduce_gradients(grads)),
           "all_gather_masters_ms": median_ms(lambda: zero.all_gather(masters)),
           "norm_ms": median_ms(lambda: trainer.zero.norm(grads, optim.global_norm))}
    if alone_s:
        out["speedup"] = out["group_clips_per_s"] / out["alone_clips_per_s"]
    if grid.tp > 1:
        dp_all = [None] * mesh.world()
        dist.all_gather_object(dp_all, dp_s)
        out["data_parallel_s"] = dp_all[0]
        out["data_parallel_clips_per_s"] = grid.dp * args.timed / dp_all[0]
        out["grid_over_data_parallel"] = out["group_clips_per_s"] / out["data_parallel_clips_per_s"]

        def replay_gathers():
            for shape, dtype in gathers:
                x = torch.zeros(shape, dtype=dtype, device=device)
                parts = torch.empty(grid.tp * x.numel(), dtype=dtype, device=device)
                dist.all_gather_into_tensor(parts, x.view(-1), group=grid.tensor_group)

        def replay_sums():
            for shape, dtype in sums:
                dist.all_reduce(torch.zeros(shape, dtype=dtype, device=device),
                                group=grid.tensor_group)

        out["tensor_group"] = {
            "gathers": len(gathers),
            "gather_bytes": sum(grid.tp * math.prod(sh) * torch.finfo(dt).bits // 8
                                for sh, dt in gathers),
            "gathers_ms": median_ms(replay_gathers, grid.tensor_group),
            "input_gradient_sums": len(sums),
            "sum_bytes": sum(math.prod(sh) * torch.finfo(dt).bits // 8 for sh, dt in sums),
            "sums_ms": median_ms(replay_sums, grid.tensor_group)}
    return out


def _peaks(args, device, grid, masters0, clips, draws, trainer_on) -> dict:
    """(d): each rank's peak over two micro-steps at each listed tensor
    axis that divides the world, replicated and with ZeRO-1."""
    from mgldvsr_tpu_torch.parallel import mesh

    world = mesh.world()
    out = {}
    for tp in args.peak_tp:
        if tp == grid.tp or world % tp:
            continue
        g = mesh.init_grid(tp)
        lq, gt = clips[0]  # the memory a clip takes does not depend on which
        row = {}
        for name, zero1 in (("replicated", False), ("zero1", True)):
            trainer = trainer_on(g, zero1)
            state = _fresh_state(trainer, masters0)
            _reset_peak(device)
            for step in range(2):
                state, _ = trainer.train_step(state, lq, gt, draws=draws(trainer, step, 0))
            _sync(device)
            peaks = [None] * world
            torch.distributed.all_gather_object(peaks, _peak_gib(device))
            row[name] = peaks
            del trainer, state
        out[f"tp{tp}"] = row
    return out


def _norm_spread(got: dict, want: dict) -> tuple:
    """(worst leaf distance over its norm plus 1e-3 of the largest leaf
    norm, the whole gradient's over its norm)."""
    norms = {k: float(w.norm()) for k, w in want.items()}
    big = max(norms.values())
    d = {k: float((got[k].float() - w.float()).norm()) for k, w in want.items()}
    whole = (sum(v * v for v in d.values()) / sum(n * n for n in norms.values())) ** 0.5
    return max(d[k] / (norms[k] + 1e-3 * big) for k in d), whole


def _stage2(args, device, grid, report) -> bool:
    """(b)."""
    from mgldvsr_tpu_torch.cli import train as cli
    from mgldvsr_tpu_torch.models.vae import VideoAutoencoderKLResi
    from mgldvsr_tpu_torch.parallel import mesh
    from mgldvsr_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer

    rank = mesh.rank()
    src = _pipeline("tiny", args.seed, device)
    vae_sd = {k: v.clone() for k, v in src.vae.state_dict().items()}
    cfg = Stage2Config(num_frames=5, grad_accum=2, disc_start=0)
    size = 64
    data = []
    for r in range(grid.dp):
        lq, gt = _clip(args.seed + 50 + r, size, 5, device)
        lat = torch.from_numpy(np.random.RandomState(args.seed + 60 + r).randn(
            5, size // 8, size // 8, 4).astype(np.float32)).to(device)
        data.append((lq, gt, lat))

    def trainer(g):
        vae = VideoAutoencoderKLResi(src.cfg.vae).to(device)
        vae.load_state_dict(vae_sd)
        tr = Stage2Trainer(vae, cfg, grid=g)
        cli.seed_stage2_aux(tr, args.seed)
        with torch.no_grad():  # random SpyNet flows would be occluded everywhere
            for level in tr.spynet.basic_module:
                level.basic_module[8].weight.mul_(1e-2)
                level.basic_module[8].bias.mul_(1e-2)
        return tr, tr.shard(tr.init_state())

    def run(tr, state, batch):
        snaps = []
        for _ in range(2):
            state, m = tr.train_step(state, *batch)
            full = tr.gather(state)  # whole on the grid
            snaps.append({"m": {k: float(v) for k, v in m.items()},
                          "acc_g": {k: v.clone() for k, v in full.opt_g["acc"].items()},
                          "acc_d": {k: v.clone() for k, v in full.opt_d["acc"].items()},
                          "stats": {k: v.clone() for k, v in full.disc.items()
                                    if "running" in k},
                          "mu_g": {k: v.clone() for k, v in full.opt_g["mu"].items()},
                          "mu_d": {k: v.clone() for k, v in full.opt_d["mu"].items()}})
        return snaps

    tr, state = trainer(grid)
    split = 0 if tr.zero.tensor is None else len(tr.zero.tensor.axes)
    got = run(tr, state, data[grid.data_index])
    del tr, state
    ok = True
    if rank == 0:
        batch = tuple(torch.cat(parts) for parts in zip(*data))
        tr, state = trainer(None)
        want = run(tr, state, batch)
        # the witness: one process with the latents moved by 1e-6 relative
        gen = torch.Generator(device=device).manual_seed(args.seed + 70)
        moved = batch[2] * (1 + 1e-6 * torch.randn(batch[2].shape, device=device,
                                                   generator=gen))
        tr, state = trainer(None)
        witness = run(tr, state, (*batch[:2], moved))
        m, w = got[0]["m"], want[0]["m"]
        scale = abs(w["logits_real"]) + abs(w["logits_fake"])
        metric = max(abs(m[k] - w[k]) / max(abs(w[k]), scale if k in (
            "g_loss", "logits_real", "logits_fake") else abs(w[k])) for k in S2_METRICS)
        parts = {"gen_acc": (0, "acc_g"), "disc_acc": (0, "acc_d"), "gen_mu": (1, "mu_g"),
                 "disc_mu": (1, "mu_d")}
        spread = {k: _norm_spread(got[i][part], want[i][part]) for k, (i, part) in parts.items()}
        reach = {k: _norm_spread(witness[i][part], want[i][part])
                 for k, (i, part) in parts.items()}
        stats = max(float((g[k] - v).abs().max()) / float(v.abs().max())
                    for g, wt in ((got[0]["stats"], want[0]["stats"]),
                                  (got[1]["stats"], want[1]["stats"]))
                    for k, v in wt.items())
        # phase 9 (a)'s limits, or 1.5x as far as the witness reaches (a
        # LeakyReLU or hinge input within rounding of zero: ROADMAP section 3)
        held = all(leaf <= max(S2_LEAF[k.split("_")[0]], 1.5 * reach[k][0])
                   and whole <= max(S2_WHOLE[k.split("_")[0]], 1.5 * reach[k][1])
                   for k, (leaf, whole) in spread.items())
        ok = metric <= S2_METRIC_REL and held and stats <= S2_STATS_REL
        report["stage2"] = {"metric_rel": metric, "stats_rel": stats, "tensor_split": split,
                            "leaf_and_whole": spread, "witness_leaf_and_whole": reach,
                            "d_weight": [g["m"]["d_weight"] for g in got], "ok": ok}
    return ok


def run(args) -> int:
    import datetime

    import torch.distributed as dist

    from mgldvsr_tpu_torch.parallel import mesh
    from mgldvsr_tpu_torch.utils.precision import tf32_off

    device = mesh.init_group(args.device, args.init_method,
                             timeout=datetime.timedelta(seconds=args.timeout))
    try:
        mesh.TENSOR_MIN_OUT = args.tensor_min_out
        grid = mesh.init_grid(args.tensor_parallel)
        report = {"world": mesh.world(), "grid": {"data": grid.dp, "tensor": grid.tp},
                  "tensor_min_out": args.tensor_min_out, "device": str(device),
                  "preset": args.preset, "steps": args.steps}
        t0 = time.perf_counter()
        with tf32_off():
            ok = _stage1(args, device, grid, report)
            ok = _stage2(args, device, grid, report) and ok
        report["wall_s"] = time.perf_counter() - t0
        if mesh.rank() == 0:
            if device.type == "cuda":
                report["cards"] = subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                    capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
            report["ok"] = ok
            print(json.dumps(report, default=str), flush=True)
        flag = torch.tensor([int(ok)], device=device)
        dist.broadcast(flag, 0)
        return 0 if flag.item() else 1
    finally:
        mesh.destroy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default: NCCL) or cpu (gloo)")
    ap.add_argument("--preset", choices=["full", "tiny"], default="full",
                    help="stage 1's widths (stage 2 runs at tiny widths)")
    ap.add_argument("--steps", type=int, default=4, help="stage-1 micro-steps of (a)")
    ap.add_argument("--timed", type=int, default=6, help="stage-1 micro-steps timed in (c)")
    ap.add_argument("--tensor-parallel", type=int, default=1,
                    help="the grid's tensor axis (degraded to the largest divisor of N that is "
                         "at most it)")
    ap.add_argument("--peak-tp", type=lambda v: [int(t) for t in v.split(",") if t],
                    default=[], help="(d): the tensor axes to measure each rank's peak at, "
                                     "comma-separated (e.g. 1,2,4)")
    ap.add_argument("--tensor-min-out", type=int, default=256,
                    help="the tensor rule's narrowest split output (the JAX package's 256; "
                         "lower it to split the tiny preset's layers)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-method", default=None,
                    help="the process group's init method (default env://, torchrun's)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a collective may wait before the group aborts")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())

"""Training command line of the PyTorch port, the counterpart of
``mgldvsr_tpu/cli/train.py`` (the reference's Lightning ``main.py``):

  python -m mgldvsr_tpu_torch.cli.train --stage 1 --data-root REDS_GT \\
      [--config cfg.yaml ...] [--set key.path=value ...] [--logdir runs/exp] \\
      [--max-steps N] [--resume] [--tiny] [--torch-ckpt ckpt] [--device cuda|cpu]
  python -m mgldvsr_tpu_torch.cli.train --stage 2 --data-root GT --lq-root LQ \\
      --latent-root LATENTS [--config configs/video_autoencoder_kl_64x64x4_resi.yaml] ...
  torchrun --nproc_per_node=N -m mgldvsr_tpu_torch.cli.train --mesh [--zero1] \\
      [--tensor-parallel T] ...

Stage 1 finetunes the denoiser's SPADE and temporal-conv weights and the
struct-cond encoder on clips degraded on the fly (the shipped two-stage
RealBasicVSR recipe, or the config's ``data:`` section). The YAML sections
``train:`` (flag defaults), ``data:`` (dataset keywords and the two
degradation stages) and ``model:`` (the pipeline's widths and dtypes) read
as in the JAX command line. A step is one micro-step: one clip, one
gradient, an optimiser update every ``--grad-accum`` steps.

Writes ``metrics.jsonl``, TensorBoard events under ``tb/``, image grids
under ``images/``, checkpoints under ``ckpt/`` (every ``--ckpt-every``
steps, on SIGUSR1, and on Ctrl-C) and, at the end, the EMA parameters as an
MGLD-VSR checkpoint (``export/mgld_ema.pt``, plus ``export/raft.pt``) that
``mgldvsr_tpu_torch.cli.infer --torch-ckpt ... --raft-ckpt ...`` loads.
``--resume`` continues from the latest checkpoint: the optimiser, EMA,
accumulator and step, the data stream at the next clip, and the draws (each
step's generator is seeded from ``--seed`` and the step). Both stages keep
TF32 off for float32 matmuls and cuDNN convolutions, say so on their first
line, and put both flags back when they end.

Stage 2 finetunes the video VAE decoder's fusion and temporal layers on
windows of GT frames (``--data-root``), LQ frames (``--lq-root``) and the
latents the inference CLI's latent mode wrote for them (``--latent-root``),
with LPIPS, a PatchGAN discriminator and SpyNet in the loss. The trainer
starts from the pipeline's VAE (``--torch-ckpt`` / ``--vqgan-ckpt``, or
seeded weights), and decodes the stored latents divided by the diffusion
scale factor: the JAX command line does neither (it starts from a fresh
random VAE and decodes the scaled latents). LPIPS, the discriminator and
SpyNet are seeded from ``--seed``; their modules keep the upstream key
names (taming's, basicsr's), so their checkpoints load with a plain
``load_state_dict``. At the end the VAE is exported as ``export/vqgan.pt``, which
the inference CLI loads with ``--vqgan-ckpt``.

``--mesh`` trains either stage data-parallel over the ranks of a
``torchrun`` launch: one process and one card a rank (NCCL; gloo with
``--device cpu``), one clip a rank a micro-step, so that a micro-step is the
JAX command line's step on one clip per ``data`` slot: the ranks average
their gradients every micro-step, the losses are the whole batch's, and
stage 2's discriminator normalises with the whole batch's statistics.
``--zero1`` adds the JAX package's ZeRO-1 split of the optimiser state over
the ranks. ``--tensor-parallel T`` lays the N ranks out as JAX's
``('data', 'tensor')`` mesh of N / T x T (T degraded to the largest divisor
of N that is at most T, as JAX degrades it; the command prints the mesh):
the T ranks of a data index take the same clip and draws, and every tower
holds its rank's rows of the kernels the JAX rule splits (output axes at
least 256 wide; not norms, embeddings or logvar), each such layer's output
gathered at once, so the step is the data-parallel step on the N / T clips;
``--zero1`` then splits over the data ranks. Without ``--mesh``,
``--tensor-parallel 1`` is the JAX default and changes nothing. Each data
index draws its own shard of the clips (a resume continues it), and seeds
its draws from ``--seed``, the step and its data index (index 0's as
without ``--mesh``). Rank 0 alone logs, writes images, checkpoints (the
whole state, in the single-process layout: it resumes in any grid, and
without ``--mesh``) and the export, and reads the checkpoint it resumes
from, which it hands to the other ranks. SIGUSR1 or Ctrl-C on any rank
saves at the end of the micro-step on every rank. ``--multihost`` is the
same path: ``torchrun --nnodes=N`` starts the ranks of every host.

Not offered: ``--params`` (an orbax directory: the card's machine has
neither JAX nor orbax; give ``--torch-ckpt``); ``--split-step`` (a TPU
compile workaround for stage 2; the port's step is eager).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import signal
import time

from mgldvsr_tpu_torch.cli.infer import tiny_pipeline_config, with_tower_settings
from mgldvsr_tpu_torch.utils.precision import TF32_LINE, tf32_off

REFUSED = {
    "--params": "reads an orbax directory, which needs JAX; give --torch-ckpt (ROADMAP "
                "section 1, 'Do not port')",
    "--split-step": "a TPU compile workaround for stage 2; the port's step is eager "
                    "(ROADMAP section 1, 'Do not port')",
    "--platform": "the port picks its device with --device",
}


def default_degradation_cfg():
    """The shipped stage-1 degradation recipe (the JAX command line's)."""
    blur = dict(
        kernel_size=[7, 9, 11, 13, 15, 17, 19, 21],
        kernel_list=["iso", "aniso", "generalized_iso", "generalized_aniso",
                     "plateau_iso", "plateau_aniso", "sinc"],
        kernel_prob=[0.405, 0.225, 0.108, 0.027, 0.108, 0.027, 0.1],
        sigma_x=[0.2, 3], sigma_y=[0.2, 3],
        rotate_angle=[-3.1416, 3.1416],
        beta_gaussian=[0.5, 4], beta_plateau=[1, 2],
        sigma_x_step=0.02, sigma_y_step=0.02, rotate_angle_step=0.31416,
        beta_gaussian_step=0.05, beta_plateau_step=0.1, omega_step=0.0628,
    )
    mpeg = dict(params=dict(codec=["libx264", "h264", "mpeg4"],
                            codec_prob=[0.3333, 0.3333, 0.3334], bitrate=[1e4, 1e5]))
    deg1 = dict(
        random_blur=dict(params=blur),
        random_resize=dict(params=dict(
            resize_mode_prob=[0.2, 0.7, 0.1], resize_scale=[0.15, 1.5],
            resize_opt=["bilinear", "area", "bicubic"],
            resize_prob=[0.3333, 0.3333, 0.3334], resize_step=0.015,
            is_size_even=True)),
        random_noise=dict(params=dict(
            noise_type=["gaussian", "poisson"], noise_prob=[0.5, 0.5],
            gaussian_sigma=[1, 30], gaussian_gray_noise_prob=0.4,
            poisson_scale=[0.05, 3], poisson_gray_noise_prob=0.4,
            gaussian_sigma_step=0.1, poisson_scale_step=0.005)),
        random_jpeg=dict(params=dict(quality=[30, 95], quality_step=3)),
        random_mpeg=mpeg,
    )
    blur2 = dict(blur, prob=0.8, sigma_x=[0.2, 1.5], sigma_y=[0.2, 1.5])
    deg2 = dict(
        random_blur=dict(params=blur2),
        random_resize=dict(params=dict(
            resize_mode_prob=[0.3, 0.4, 0.3], resize_scale=[0.3, 1.2],
            resize_opt=["bilinear", "area", "bicubic"],
            resize_prob=[0.3333, 0.3333, 0.3334], resize_step=0.03,
            is_size_even=True)),
        random_noise=dict(params=dict(
            noise_type=["gaussian", "poisson"], noise_prob=[0.5, 0.5],
            gaussian_sigma=[1, 25], gaussian_gray_noise_prob=0.4,
            poisson_scale=[0.05, 2.5], poisson_gray_noise_prob=0.4,
            gaussian_sigma_step=0.1, poisson_scale_step=0.005)),
        random_jpeg=dict(params=dict(quality=[30, 95], quality_step=3)),
        random_mpeg=mpeg,
        resize_final=dict(params=dict(
            target_size=[128, 128], resize_opt=["bilinear", "area", "bicubic"],
            resize_prob=[0.3333, 0.3333, 0.3334])),
        blur_final=dict(params=dict(
            prob=0.8, kernel_size=[7, 9, 11, 13, 15, 17, 19, 21],
            kernel_list=["sinc"], kernel_prob=[1.0],
            omega=[1.0472, 3.1416], omega_step=0.0628)),
    )
    return deg1, deg2


def parse_args(argv=None):
    # config files and KEY.PATH=VALUE overrides: their train: values become
    # argparse defaults, explicit flags win
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", action="append", default=[],
                     help="YAML config(s), merged left to right (see configs/)")
    pre.add_argument("--set", dest="overrides", action="append", default=[],
                     metavar="KEY.PATH=VALUE", help="dotlist config overrides")
    pre_args, _ = pre.parse_known_args(argv)
    cfg = {}
    if pre_args.config or pre_args.overrides:
        from mgldvsr_tpu_torch.utils.config import load_config

        cfg = load_config(pre_args.config, pre_args.overrides)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0], parents=[pre])
    ap.add_argument("--stage", type=int, choices=[1, 2], default=1)
    ap.add_argument("--data-root", required=True, help="GT frames root")
    ap.add_argument("--lq-root", help="stage 2: LQ frames root")
    ap.add_argument("--latent-root", help="stage 2: root of the latent mode's latents")
    ap.add_argument("--logdir", default="runs/default")
    ap.add_argument("--max-steps", type=int, default=800_000)
    ap.add_argument("--gt-size", type=int, default=512)
    ap.add_argument("--num-frames", type=int, default=5)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--grad-accum", type=int, default=4)
    ap.add_argument("--frozen-dtype", default=None, choices=[None, "bfloat16"],
                    help="accepted for the JAX command line's configs: the port always holds "
                         "the frozen towers in their compute dtype, which is what this flag "
                         "does there (bit-identical compute)")
    ap.add_argument("--mu-dtype", default=None, choices=[None, "bfloat16"],
                    help="Adam first-moment dtype (bfloat16 halves its bytes; the variance "
                         "stays float32)")
    ap.add_argument("--ckpt-every", type=int, default=3000)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--image-every", type=int, default=750)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--tiny", action="store_true", help="tiny model widths (smoke runs)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--torch-ckpt", help="initial MGLD-VSR torch checkpoint")
    ap.add_argument("--vqgan-ckpt", help="video VAE torch checkpoint (no key prefix)")
    ap.add_argument("--raft-ckpt", help="raft-things torch checkpoint")
    ap.add_argument("--no-tb", action="store_true", help="no TensorBoard event files")
    ap.add_argument("--sample-rows", action="store_true",
                    help="log sampler rows (reconstruction / samples / denoise_row) at every "
                         "image-log step")
    ap.add_argument("--mesh", action="store_true",
                    help="train data-parallel over the ranks of a torchrun launch (one process "
                         "and one card a rank, NCCL; gloo with --device cpu): one clip a rank "
                         "a micro-step, the gradients averaged over the ranks every micro-step")
    ap.add_argument("--multihost", action="store_true",
                    help="several hosts: the same path as --mesh, which it implies (torchrun "
                         "--nnodes=N starts the ranks of every host)")
    ap.add_argument("--zero1", action="store_true",
                    help="with --mesh: split the Adam moments, the gradient accumulator and the "
                         "EMA shadows of the tensors of at least 65,536 elements over the ranks "
                         "(the parameters stay whole on every rank)")
    ap.add_argument("--tensor-parallel", type=int, default=1,
                    help="with --mesh: the tensor axis of the (data x tensor) grid of ranks: T "
                         "ranks a clip, each holding its rows of the kernels the JAX rule splits "
                         "(degraded to the largest divisor of the world that is at most T)")
    ap.add_argument("--init-method", default=None,
                    help="with --mesh: the process group's init method (default env://, which "
                         "torchrun sets up; file:///PATH for processes started with RANK, "
                         "WORLD_SIZE and LOCAL_RANK set)")
    for flag in REFUSED:
        ap.add_argument(flag, dest="refused_" + flag[2:].replace("-", "_"), nargs="?",
                        const=True, default=None, help=argparse.SUPPRESS)
    if cfg.get("train"):
        known = {a.dest for a in ap._actions}
        unknown = set(cfg["train"]) - known
        if unknown:
            raise KeyError(f"config train: unknown keys {sorted(unknown)}")
        ap.set_defaults(**cfg["train"])
    args = ap.parse_args(argv)
    for flag in REFUSED:
        if getattr(args, "refused_" + flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is not offered by the port: {REFUSED[flag]}")
    if args.stage == 2 and not (args.lq_root and args.latent_root):
        ap.error("--stage 2 needs --lq-root and --latent-root")
    args.mesh = args.mesh or args.multihost
    if args.tensor_parallel < 1:
        ap.error(f"--tensor-parallel {args.tensor_parallel}: the tensor axis needs at least 1 rank")
    if args.tensor_parallel > 1 and not args.mesh:
        ap.error(f"--tensor-parallel {args.tensor_parallel} splits the towers over the ranks of "
                 f"a torchrun launch: give --mesh")
    args.cfg = cfg
    return args


@contextlib.contextmanager
def process_group(args):
    """With ``--mesh``: join the process group (``mesh.init_group``: NCCL on
    ``cuda:{LOCAL_RANK}``, gloo for the CPU; it raises without ``RANK`` and
    ``WORLD_SIZE``), put the rank's device in ``args.device``, say which rank
    this is, and leave the group at the end. Without it, nothing."""
    if not args.mesh:
        yield
        return
    from mgldvsr_tpu_torch.parallel import mesh

    device = mesh.init_group(args.device, args.init_method)
    try:
        import torch.distributed as dist

        args.device = str(device)
        print(f"rank {mesh.rank()} of {mesh.world()} on {device} ({dist.get_backend()})",
              flush=True)
        yield
    finally:
        mesh.destroy()


def _grid(args):
    """With ``--mesh``: the world as a (data x tensor) grid of ranks
    (``mesh.init_grid(--tensor-parallel)``, collective), after printing the
    mesh as the JAX command line does; None without. The process group must
    exist (:func:`process_group`)."""
    if not args.mesh:
        return None
    import torch.distributed as dist

    from mgldvsr_tpu_torch.parallel import mesh

    if not dist.is_initialized():
        raise RuntimeError("--mesh trains in a process group: join one first "
                           "(cli.train.main does, through process_group)")
    grid = mesh.init_grid(args.tensor_parallel)
    n = mesh.world()
    hosts = n // int(os.environ.get("LOCAL_WORLD_SIZE", n))
    print(f"mesh {{'data': {grid.dp}, 'tensor': {grid.tp}}} over {n} devices, host "
          f"{os.environ.get('GROUP_RANK', 0)}/{hosts}", flush=True)
    return grid


def step_seed(seed: int, step: int, index: int) -> int:
    """The seed of a micro-step's draws for data index ``index``: index 0's
    is the run's without ``--mesh``; every other index's differs from every
    index's at every step."""
    return seed * 1_000_003 + step + (index << 40)


def tower_dtype(device: str):
    """The towers' compute dtype where the config names none: bfloat16 on
    the card, float32 on the CPU."""
    import torch

    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def build_pipeline(args):
    """The pipeline with float32 weights: ``--torch-ckpt`` (with
    ``--vqgan-ckpt`` / ``--raft-ckpt``) or seeded ones. The trainer casts
    the towers to their compute dtypes."""
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, PipelineConfig
    from mgldvsr_tpu_torch.utils.config import pipeline_config_from_dict

    dt = tower_dtype(args.device)
    model_cfg = args.cfg.get("model") or {}
    if args.tiny:
        cfg = with_tower_settings(tiny_pipeline_config(dt, num_frames=args.num_frames),
                                  model_cfg)
    else:
        cfg = pipeline_config_from_dict(model_cfg) if model_cfg else PipelineConfig()
        # a tower's dtype from the config wins; otherwise the device's
        for name in ("unet", "structcond", "vae", "clip"):
            if "dtype" not in (model_cfg.get(name) or {}):
                cfg = dataclasses.replace(
                    cfg, **{name: dataclasses.replace(getattr(cfg, name), dtype=dt)})
        cfg = dataclasses.replace(cfg, num_frames=args.num_frames)
    pipe = MGLDVSRPipeline(cfg, device=args.device)
    if args.torch_ckpt:
        from mgldvsr_tpu_torch.io.torch_ckpt import load_pipeline_checkpoints

        load_pipeline_checkpoints(pipe, args.torch_ckpt, args.vqgan_ckpt, args.raft_ckpt)
    else:
        from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights

        print("no --torch-ckpt: seeded random weights (the temporal convs get no gradient "
              "while their blend scalars are zero)", flush=True)
        init_pipeline_weights(pipe, args.seed)
    return pipe


def _loggers(args, rank: int = 0):
    """(TensorBoard writer or None, MessageLogger, CheckpointManager) of a
    run under ``--logdir``; (None, None, None) on a rank other than 0, which
    writes nothing there."""
    from mgldvsr_tpu_torch.io.checkpoint import CheckpointManager
    from mgldvsr_tpu_torch.utils.logging import MessageLogger, env_info

    if rank:
        return None, None, None
    print(env_info(), flush=True)
    os.makedirs(args.logdir, exist_ok=True)
    tb = None
    if not args.no_tb:
        from mgldvsr_tpu_torch.utils.tb import TBEventWriter

        tb = TBEventWriter(os.path.join(args.logdir, "tb"))
    msg = MessageLogger(args.max_steps, os.path.join(args.logdir, "metrics.jsonl"),
                        args.log_every, tb=tb)
    ckpt = CheckpointManager(os.path.join(args.logdir, "ckpt"),
                             save_interval_steps=args.ckpt_every)
    return tb, msg, ckpt


def _train_loop(args, ds, state, micro_step, loggers, dev, trainer, on_step=None):
    """Micro-steps from ``state.step`` to ``--max-steps`` over ``ds``'s
    samples, epoch after epoch from the sampler's stream of this rank's
    shard (a resume continues it at the next sample), prefetched in worker
    processes across epoch boundaries. ``micro_step(state, item)`` returns
    (state, metrics, after); the metrics are logged and the checkpoint saved
    (rank 0; the state gathered from the ranks' slices), then ``after()``
    runs where it is not None, then ``on_step(step, state, metrics)``.
    SIGUSR1 and Ctrl-C save: over ranks, at the end of the micro-step on
    every rank, whichever rank the signal reached. Each data index of the
    grid streams its own shard. Returns the final state (this rank's)."""
    import torch

    import torch.distributed as dist

    from mgldvsr_tpu_torch.data.datasets import ShardedSampler, prefetch_iterator
    from mgldvsr_tpu_torch.io.checkpoint import install_signal_save

    grid = trainer.grid
    ranked = grid is not None
    shard, shards = (grid.data_index, grid.dp) if ranked else (0, 1)
    tb, msg, ckpt = loggers
    held = {"state": state, "in_step": False}
    flags = {"save": False, "stop": False}
    if not ranked:
        install_signal_save(lambda: None if held["in_step"] else (held["state"].step,
                                                                  held["state"]), ckpt)
        handlers = {}
    else:
        handlers = _defer_signals(flags)
    # one clip a data index a micro-step; the epoch enlarged (EnlargedSampler's
    # ratio) so that every shard holds at least one
    sampler = ShardedSampler(len(ds), shard=shard, num_shards=shards,
                             ratio=-(-shards // max(len(ds), 1)), seed=args.seed)
    per_epoch = len(sampler.epoch(0))
    if per_epoch == 0:
        raise ValueError(f"dataset too small: epoch yields 0 clips on this shard but each "
                         f"step needs 1 (no training samples under {args.data_root})")
    step = state.step

    def stream(start):
        epoch, skip = divmod(start, per_epoch)
        while True:
            yield from sampler.epoch(epoch)[skip:]
            epoch, skip = epoch + 1, 0

    def save(step, state, metrics, force):
        if ranked and (force or step % args.ckpt_every == 0):
            state = trainer.gather(state)  # collective: every rank takes part
        if ckpt is not None:
            ckpt.save(step, state, metrics=metrics, force=force)

    items = prefetch_iterator(ds, stream(step))
    try:
        waited = time.perf_counter()
        while step < args.max_steps:
            item = next(items)
            t0 = time.perf_counter()
            held["in_step"] = True
            state, metrics, after = micro_step(state, item)
            held["state"], held["in_step"] = state, False
            step = state.step
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
            # seconds of the micro-step (upload to metrics) and of the wait
            # for its sample from the data path before it
            metrics["step_s"] = time.perf_counter() - t0
            metrics["data_wait_s"] = t0 - waited
            if step % args.log_every == 0 and dev.type == "cuda":
                metrics["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
            if msg is not None:
                msg(step, metrics, lr=args.lr)
            if not ranked:
                save(step, state, metrics, ckpt.signal_pending)
                ckpt.signal_pending = False
            else:
                # a signal that reached any rank reaches every rank here
                raised = torch.tensor([float(flags["save"]), float(flags["stop"])], device=dev)
                dist.all_reduce(raised, op=dist.ReduceOp.MAX)
                flags["stop"] = bool(raised[1])
                save(step, state, metrics, bool(raised[0]) or flags["stop"])
                flags["save"] = False
            if after is not None:
                after()
            if on_step is not None:
                on_step(step, state, metrics)
            if flags["stop"]:
                print("interrupted: checkpoint saved", flush=True)
                break
            waited = time.perf_counter()
    except KeyboardInterrupt:
        if ranked:  # a second Ctrl-C over ranks: stop at once
            raise
        save(step, state, None, True)
        print("interrupted: checkpoint saved", flush=True)
    finally:
        items.close()  # drops the samples prefetched beyond the last step
        if tb is not None:
            tb.close()
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    if ckpt is not None:
        ckpt.wait()
    return state


def _defer_signals(flags: dict) -> dict:
    """Over ranks: SIGUSR1 asks for a checkpoint and the first Ctrl-C for a
    checkpoint and a stop, each at the end of the micro-step in flight (the
    save is a collective every rank must enter at the same step); a second
    Ctrl-C interrupts at once. Returns the handlers they replace."""
    def usr1(signum, frame):
        flags["save"] = True
        print("signal save deferred to the end of the micro-step in flight", flush=True)

    def interrupt(signum, frame):
        flags["stop"] = True
        signal.signal(signal.SIGINT, signal.default_int_handler)
        print("interrupt: stopping after a checkpoint at the end of the micro-step",
              flush=True)

    return {signal.SIGUSR1: signal.signal(signal.SIGUSR1, usr1),
            signal.SIGINT: signal.signal(signal.SIGINT, interrupt)}


def _resume(args, ckpt, state, grid):
    """The state to start from (whole, in the single-process layout): with
    ``--resume`` and a checkpoint under ``--logdir``, rank 0 reads the
    latest and every rank gets it (only rank 0 needs to see the directory);
    else ``state``."""
    if not args.resume:
        return state
    step = ckpt.latest_step() if ckpt is not None else None
    if grid is not None:
        import torch.distributed as dist

        box = [step]
        dist.broadcast_object_list(box, 0)
        step = box[0]
    if step is None:
        return state
    if ckpt is not None:
        state = ckpt.restore(step, template=state)
    if grid is not None:
        from mgldvsr_tpu_torch.parallel import mesh

        state = mesh.broadcast_state(state)
    print(f"resumed at step {state.step}", flush=True)
    return state


def stage1(args, pipe=None, on_step=None):
    """The stage-1 loop; returns the final training state (whole, also over
    ranks). ``pipe`` (built with float32 weights) replaces
    :func:`build_pipeline`; ``on_step(step, state, metrics)`` runs after
    every micro-step (with this rank's state)."""
    import torch

    from mgldvsr_tpu_torch.data.datasets import RealVSRRecurrentDataset
    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
    from mgldvsr_tpu_torch.io.checkpoint import save_params
    from mgldvsr_tpu_torch.io.torch_ckpt import mgld_state_dict
    from mgldvsr_tpu_torch.parallel.tensor import gather_module_state
    from mgldvsr_tpu_torch.train.trainer import Stage1Config, Stage1Trainer, with_ema
    from mgldvsr_tpu_torch.utils.logging import ImageLogger

    grid = _grid(args)
    rank = torch.distributed.get_rank() if grid is not None else 0
    index = grid.data_index if grid is not None else 0
    # the ranks that run the sampler rows with rank 0: its tensor group
    samples_rows = args.sample_rows and index == 0
    loggers = _loggers(args, rank)
    imglog = ImageLogger(args.logdir, args.image_every, tb=loggers[0]) if rank == 0 else None
    ckpt = loggers[2]
    if pipe is None:
        pipe = build_pipeline(args)
    dev = pipe.device
    gt_size = 32 if args.tiny else args.gt_size

    deg1, deg2 = default_degradation_cfg()
    data_cfg = dict(args.cfg.get("data", {}))
    deg1 = data_cfg.pop("degradation_1", deg1)
    deg2 = data_cfg.pop("degradation_2", deg2)
    if args.tiny:
        # one stage and a fixed LQ size, as the JAX command line's --tiny
        deg1 = dict(deg1, resize_final=dict(params=dict(
            target_size=[gt_size // 4, gt_size // 4], resize_opt=["bicubic"],
            resize_prob=[1.0])))
        deg1.pop("random_mpeg", None)
        deg2 = None
    ds = RealVSRRecurrentDataset(args.data_root, num_frame=args.num_frames, gt_size=gt_size,
                                 degradation_1=deg1, degradation_2=deg2, seed=args.seed,
                                 **data_cfg)
    if rank == 0:
        print(f"data: {len(ds)} clips, frames read by the {ds.read_path} path", flush=True)
    trainer = Stage1Trainer(pipe, Stage1Config(learning_rate=args.lr,
                                               grad_accum=args.grad_accum,
                                               adam_mu_dtype=args.mu_dtype,
                                               frozen_dtype=args.frozen_dtype),
                            grid=grid, zero1=args.zero1)
    state = trainer.shard(_resume(args, ckpt, trainer.init_state(), grid))

    def micro_step(state, item):
        lq = upscale_frames(torch.from_numpy(item["lqs"]).to(dev), pipe.cfg.sf)
        gt = torch.from_numpy(item["gts"]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(step_seed(args.seed, state.step, index))
        state, metrics = trainer.train_step(state, lq, gt, gen)
        step = state.step
        if step % args.image_every or not (imglog is not None or samples_rows):
            return state, metrics, None

        def log_images():
            rows = {"lq": lq.float().cpu().numpy(), "gt": gt.float().cpu().numpy()}
            if args.sample_rows:  # every rank of rank 0's tensor group samples
                sgen = torch.Generator(device=dev).manual_seed(args.seed + step)
                rows.update({k: v.float().cpu().numpy()
                             for k, v in pipe.log_images(lq, sgen).items()})
            if imglog is not None:
                imglog.log_images(step, rows)

        return state, metrics, log_images

    state = trainer.gather(_train_loop(args, ds, state, micro_step, loggers, dev, trainer,
                                       on_step))
    # the towers whole on every rank (collective under --tensor-parallel)
    towers = {t: gather_module_state(m) for t, m in pipe.towers().items()}
    state = state._replace(frozen={k: towers[k.partition(".")[0]][k.partition(".")[2]]
                                   for k in state.frozen})
    if rank == 0:
        export = os.path.join(args.logdir, "export")
        os.makedirs(export, exist_ok=True)
        save_params(os.path.join(export, "mgld_ema.pt"), {"state_dict": mgld_state_dict(
            with_ema(state))})
        save_params(os.path.join(export, "raft.pt"),
                    {k: v.float() for k, v in towers["raft"].items()})
        print(f"exported the EMA parameters to {export}", flush=True)
    return state


def seed_stage2_aux(trainer, seed: int) -> None:
    """Seeded LPIPS, discriminator and SpyNet weights, on the trainer's
    device (one generator, in that order)."""
    import torch

    from mgldvsr_tpu_torch.io.init_weights import init_module_weights

    gen = torch.Generator(device=trainer.device).manual_seed(seed + 2)
    for module in (trainer.lpips, trainer.disc, trainer.spynet):
        init_module_weights(module, gen)


def stage2(args, pipe=None, on_step=None, on_trainer=None):
    """The stage-2 loop; returns the final training state (whole, also over
    ranks). ``pipe`` (built with float32 weights) replaces
    :func:`build_pipeline`; ``on_trainer(trainer)`` runs once the loss
    networks are loaded, before the state is made; ``on_step(step, state,
    metrics)`` runs after every micro-step (with this rank's state)."""
    import torch

    from mgldvsr_tpu_torch.data.datasets import REDSAutoencoderDataset
    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
    from mgldvsr_tpu_torch.io.checkpoint import save_params
    from mgldvsr_tpu_torch.parallel.tensor import gather_module_state
    from mgldvsr_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer

    grid = _grid(args)
    rank = torch.distributed.get_rank() if grid is not None else 0
    loggers = _loggers(args, rank)
    ckpt = loggers[2]
    ds = REDSAutoencoderDataset(args.data_root, args.lq_root, args.latent_root,
                                num_frame=args.num_frames)
    if pipe is None:
        pipe = build_pipeline(args)
    dev = pipe.device
    trainer = Stage2Trainer(pipe.vae, Stage2Config(learning_rate=args.lr,
                                                   grad_accum=args.grad_accum,
                                                   num_frames=args.num_frames),
                            grid=grid, zero1=args.zero1)
    seed_stage2_aux(trainer, args.seed)
    if on_trainer is not None:
        on_trainer(trainer)
    state = trainer.shard(_resume(args, ckpt, trainer.init_state(), grid))

    def micro_step(state, item):
        lq = upscale_frames(torch.from_numpy(item["lqs"]).to(dev), 4)
        gt = torch.from_numpy(item["gts"]).to(dev)
        # the latent mode stores scale_factor * z; the decoder takes z
        lat = torch.from_numpy(item["lts"]).to(dev) / pipe.cfg.scale_factor
        return (*trainer.train_step(state, lq, gt, lat), None)

    state = trainer.gather(_train_loop(args, ds, state, micro_step, loggers, dev, trainer,
                                       on_step))
    vae = {k: v.float() for k, v in gather_module_state(pipe.vae).items()}  # collective
    if rank == 0:
        export = os.path.join(args.logdir, "export")
        os.makedirs(export, exist_ok=True)
        vae.update(state.trainable)
        save_params(os.path.join(export, "vqgan.pt"), {"state_dict": vae})
        print(f"exported the VAE to {export}", flush=True)
    return state


def main(argv=None):
    """Train stage 1 or 2, with TF32 off (restored on exit); with
    ``--mesh`` as one rank of the process group."""
    args = parse_args(argv)
    with process_group(args):
        print(TF32_LINE, flush=True)
        t0 = time.time()
        with tf32_off():
            (stage1 if args.stage == 1 else stage2)(args)
        print(f"done in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()

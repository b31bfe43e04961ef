"""Stage-1 training: finetune the denoiser's SPADE and temporal-conv
weights and the whole struct-cond encoder on degraded clips.

Counterpart of ``mgldvsr_tpu/train/trainer.py``: the trainable set, a
per-frame random timestep, the struct-cond features of the LQ latent at
that timestep, the eps-MSE loss (logvar fixed at zero, optional ELBO term),
a LitEma shadow with its warm-up, and gradient accumulation
(:mod:`mgldvsr_tpu_torch.train.optim`).

Precision is the JAX trainer's: the trainables are float32 masters held
here, and the towers compute with weights in their compute dtype (bf16 at
full width), as flax casts every parameter to the module's dtype when it
applies it. A micro-step's gradient is the towers' ``.grad`` cast to float32
at once; after an applied update the masters are copied into the towers.
The frozen towers (VAE, text tower, RAFT, the rest of the UNet) hold their
compute dtype and receive no gradient.

:meth:`Stage1Trainer.train_step` updates the state's tensors in place (the
JAX command line donates its state the same way) and returns the state.

Over several ranks (``group``, one clip a rank) a micro-step is the JAX
step on the batch of every rank's clip: each rank averages its float32
gradient over the group before the norm and the optimiser (the JAX step's
``psum`` inside every micro-step, before ``MultiSteps`` averages), and
reports the loss terms as group means. With ``zero1`` the moments, the
accumulator and the EMA shadows of the large trainables are split over the
ranks (:class:`~mgldvsr_tpu_torch.parallel.mesh.ZeroShard`):
:meth:`Stage1Trainer.shard` cuts a full state to this rank's,
:meth:`Stage1Trainer.gather` puts it back together.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from mgldvsr_tpu_torch.core.schedules import q_sample, respace_schedule
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, upscale_frames
from mgldvsr_tpu_torch.parallel import mesh
from mgldvsr_tpu_torch.train import optim

Tensors = Dict[str, torch.Tensor]
TRAIN_TOWERS = ("unet", "structcond")


# ---------------------------------------------------------------------------
# Parameter partitioning
# ---------------------------------------------------------------------------


def is_trainable(name: str) -> bool:
    """Whether ``tower.param`` (a port name) is trained in stage 1.

    The JAX trainer selects on flax paths: every struct-cond parameter, and
    UNet paths containing ``spade`` or ``temporal``. In the UNet's flax tree
    only SPADE's parameters and the temporal convs' ``temporal_conv`` kernel
    and bias carry those words: the temporal attention is ``mid_tattn`` and
    the blend scalars are ``alpha``, so both stay frozen. The port's names
    for that set are the ``spade.`` and ``temporal_conv.`` parameters."""
    tower, _, rest = name.partition(".")
    if tower == "structcond":
        return True
    return tower == "unet" and (".spade." in f".{rest}" or ".temporal_conv." in f".{rest}")


def named_tower_parameters(pipe: MGLDVSRPipeline):
    """(``tower.name``, parameter) over every tower of the pipeline."""
    for tower, module in pipe.towers().items():
        for name, p in module.named_parameters():
            yield f"{tower}.{name}", p


def partition_params(pipe: MGLDVSRPipeline) -> Tuple[Tensors, Tensors]:
    """(trainable, frozen): the towers' parameters by :func:`is_trainable`,
    the tensors themselves (not copies)."""
    train, frozen = {}, {}
    for name, p in named_tower_parameters(pipe):
        (train if is_trainable(name) else frozen)[name] = p
    return train, frozen


def merge_params(trainable: Tensors, frozen: Tensors) -> Tensors:
    """One flat dict, the trainables over the frozen."""
    out = dict(frozen)
    out.update(trainable)
    return out


# ---------------------------------------------------------------------------
# EMA (LitEma: decay warm-up (1+n)/(10+n), a shadow of the trainables)
# ---------------------------------------------------------------------------


@torch.no_grad()
def ema_update(shadow: Tensors, new: Tensors, num_updates: int, decay: float = 0.9999) -> None:
    """``s -= (1 - d)(s - p)`` in place with d = min(decay, (1+n)/(10+n)),
    in float32 as the JAX trainer computes it."""
    n = torch.tensor(float(num_updates), dtype=torch.float32)
    d = torch.minimum(torch.tensor(decay, dtype=torch.float32), (1.0 + n) / (10.0 + n))
    w = (1.0 - d).item()  # float32 1 - d, as a scalar of each shadow's type
    for k, s in shadow.items():
        s.copy_(s - w * (s - new[k]))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    learning_rate: float = 5.0e-5
    grad_accum: int = 4
    ema_decay: float = 0.9999
    use_ema: bool = True
    original_elbo_weight: float = 0.0
    l_simple_weight: float = 1.0
    max_grad_norm: Optional[float] = None
    time_replace: Optional[int] = None  # train-time respacing (None = 1000)
    # 'bfloat16': the Adam first moment in bf16 (the variance stays fp32)
    adam_mu_dtype: Optional[str] = None
    # accepted for the JAX trainer's configs: the port always holds the
    # frozen towers in their compute dtype, which is what 'bfloat16' does
    # there with bit-identical compute
    frozen_dtype: Optional[str] = None


class TrainState(NamedTuple):
    trainable: Tensors      # float32 masters, "tower.name"
    frozen: Tensors         # the towers' frozen parameters (live, not copies)
    opt_state: dict         # optim.init_opt_state
    ema: Optional[Tensors]  # float32 shadows of the trainables
    step: int               # micro-steps taken


class Stage1Draws(NamedTuple):
    """The four draws of one micro-step, NHWC where they are latents: the
    posterior noises of the LQ and GT encodes, the respaced timestep of each
    frame, and the eps noise (the JAX trainer's ``split(rng, 4)``)."""
    lq_posterior: torch.Tensor
    gt_posterior: torch.Tensor
    t: torch.Tensor
    noise: torch.Tensor


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def group_means(values: Dict[str, torch.Tensor], zero) -> Dict[str, torch.Tensor]:
    """0-dim metrics as means over the group of ``zero`` (a ``ZeroShard``),
    in one collective; as they are without one."""
    if zero is None:
        return values
    stacked = mesh.all_reduce_mean({"m": torch.stack(list(values.values()))}, zero.group)["m"]
    return dict(zip(values, stacked.unbind()))


class Stage1Trainer:
    """``group``: the ranks that train together, one clip each (None: this
    process alone); ``zero1``: split the optimiser state over them, the
    leaves of at least ``mesh.ZERO1_MIN_SIZE`` elements (read when the
    trainer is made)."""

    def __init__(self, pipe: MGLDVSRPipeline, cfg: Stage1Config = Stage1Config(), group=None,
                 zero1: bool = False):
        self.pipe = pipe
        self.cfg = cfg
        self.device = pipe.device
        if cfg.time_replace and cfg.time_replace != pipe.cfg.timesteps:
            self.sched = respace_schedule(pipe.base_sched, cfg.time_replace)
        else:
            self.sched = pipe.base_sched
        mu = {None: None, "bfloat16": torch.bfloat16, "float32": None}[cfg.adam_mu_dtype]
        self.opt_cfg = optim.AdamWConfig(learning_rate=cfg.learning_rate, mu_dtype=mu,
                                         max_grad_norm=cfg.max_grad_norm,
                                         grad_accum=cfg.grad_accum)
        self._towers_hold = None  # the master dict the towers were last loaded from
        self.group = group
        self.zero = None
        if group is not None:
            shapes = {k: p.shape for k, p in partition_params(pipe)[0].items()}
            self.zero = mesh.ZeroShard(shapes, group, zero1)

    def init_state(self) -> TrainState:
        """Float32 masters of the towers' trainables, read before the towers
        are cast to their compute dtypes (load float32 weights first)."""
        train, _ = partition_params(self.pipe)
        masters = {k: p.detach().float().clone() for k, p in train.items()}
        self.pipe.cast_to_compute_dtypes()
        _, frozen = partition_params(self.pipe)
        state = TrainState(
            trainable=masters, frozen=frozen,
            opt_state=optim.init_opt_state(masters, self.opt_cfg),
            ema={k: v.clone() for k, v in masters.items()} if self.cfg.use_ema else None,
            step=0)
        self.load_towers(state)
        return state

    def shard(self, state: TrainState) -> TrainState:
        """A full state (``init_state``'s, a checkpoint's) -> this rank's."""
        return state if self.zero is None else mesh.shard_state(state, self.zero)

    def gather(self, state: TrainState) -> TrainState:
        """This rank's state -> the full one, on every rank (collective)."""
        return state if self.zero is None else mesh.gather_state(state, self.zero)

    @torch.no_grad()
    def load_towers(self, state: TrainState) -> None:
        """Copy the masters into the towers' compute-dtype parameters, in
        place (so caches keyed on a weight's version see the change); only
        those parameters take a gradient."""
        train, frozen = partition_params(self.pipe)
        for p in frozen.values():
            p.requires_grad_(False)
        for k, p in train.items():
            p.requires_grad_(True)
            p.copy_(state.trainable[k])
        self._towers_hold = state.trainable

    # -- loss --------------------------------------------------------------

    def p_losses(self, z_gt: torch.Tensor, z_lq: torch.Tensor, context: torch.Tensor,
                 t: torch.Tensor, noise: torch.Tensor):
        """Denoising loss at per-frame respaced timesteps ``t``; latents
        NHWC. Runs the struct-cond encoder and the UNet with gradient."""
        sched = self.sched
        x_noisy = q_sample(sched, z_gt, t, noise)
        t_ori = sched.timestep_map[t]
        s_cond = self.pipe.structcond(_nchw(z_lq), t_ori)
        out = self.pipe.unet(_nchw(x_noisy), t_ori, context, s_cond).permute(0, 2, 3, 1)
        err = (out - noise) ** 2
        loss_simple = err.mean(dim=(1, 2, 3))
        # logvar fixed at zero (learn_logvar False): loss == loss_simple
        loss = self.cfg.l_simple_weight * loss_simple.mean()
        loss_vlb = (sched.lvlb_weights[t] * loss_simple).mean()
        loss = loss + self.cfg.original_elbo_weight * loss_vlb
        return loss, {"loss_simple": loss_simple.mean().detach(), "loss_vlb": loss_vlb.detach()}

    def draws(self, n: int, h: int, w: int, generator: Optional[torch.Generator]
              ) -> Stage1Draws:
        """The four draws of a micro-step from ``generator``, for ``n``
        frames of ``h`` x ``w`` latents."""
        dev = self.device
        shape = (n, h, w, self.pipe.cfg.vae.embed_dim)

        def randn():
            return torch.randn(shape, generator=generator, device=dev)

        lq, gt = randn(), randn()
        t = torch.randint(0, self.sched.num_timesteps, (n,), generator=generator, device=dev)
        return Stage1Draws(lq, gt, t, randn())

    # -- full step ---------------------------------------------------------

    def loss_and_grads(self, lq_01: torch.Tensor, gt_01: torch.Tensor, draws: Stage1Draws
                       ) -> Tuple[torch.Tensor, Dict[str, Any], Tensors]:
        """The micro-step's loss, metrics and float32 gradient of every
        trainable (``tower.name``), with the towers as they stand."""
        pipe = self.pipe
        lq = lq_01 * 2.0 - 1.0
        gt = gt_01 * 2.0 - 1.0
        # frozen encodes and the empty prompt: no gradient, as stop_gradient
        z_lq, _ = pipe.encode(lq, noise=draws.lq_posterior)
        z_gt, _ = pipe.encode(gt, noise=draws.gt_posterior)
        context = pipe.embed_empty_prompt(z_gt.shape[0])
        train, _ = partition_params(pipe)
        for p in train.values():
            p.grad = None
        with torch.enable_grad():
            loss, metrics = self.p_losses(z_gt, z_lq, context, draws.t.to(self.device),
                                          draws.noise)
            loss.backward()
        # each micro-step's gradient in float32 at once
        grads = {k: p.grad.float() for k, p in train.items()}
        for p in train.values():
            p.grad = None
        return loss.detach(), metrics, grads

    def train_step(self, state: TrainState, lq_01: torch.Tensor, gt_01: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Stage1Draws] = None) -> Tuple[TrainState, Dict[str, Any]]:
        """lq_01: [(b t), H, W, 3] already upscaled to the GT size, in
        [0, 1]; gt_01 the same. ``draws`` injects the micro-step's four
        draws (parity tests); otherwise they come from ``generator``.
        Returns the state (its tensors updated in place) and the metrics as
        0-dim tensors (over a group: this rank's state, the group's
        metrics)."""
        if self._towers_hold is not state.trainable:
            self.load_towers(state)
        if draws is None:
            n, hh, ww, _ = gt_01.shape
            draws = self.draws(n, hh // 8, ww // 8, generator)
        loss, metrics, grads = self.loss_and_grads(lq_01, gt_01, draws)
        zero = self.zero
        if zero is not None:
            grads = zero.reduce_gradients(grads)
            metrics = group_means(dict(metrics, loss=loss), zero)
            loss = metrics.pop("loss")
            grad_norm = zero.norm(grads, optim.global_norm)
        else:
            grad_norm = optim.global_norm(grads)
        with torch.no_grad():
            applied = optim.step(grads, state.opt_state, state.trainable, self.opt_cfg, zero)
        del grads
        if applied:
            self.load_towers(state)
        step = state.step + 1
        if state.ema is not None:
            masters = state.trainable if zero is None else zero.locals(state.trainable)
            ema_update(state.ema, masters, step, self.cfg.ema_decay)
        metrics = dict(metrics, loss=loss, grad_norm=grad_norm)
        return state._replace(step=step), metrics

    def train_step_from_raw(self, state: TrainState, lq_small_01: torch.Tensor,
                            gt_01: torch.Tensor, generator: Optional[torch.Generator] = None,
                            draws: Optional[Stage1Draws] = None):
        """Bicubic-upscale the LQ clip by ``sf`` first."""
        lq_up = upscale_frames(lq_small_01, self.pipe.cfg.sf)
        return self.train_step(state, lq_up, gt_01, generator, draws)


def with_ema(state: TrainState) -> Tensors:
    """Every parameter with the EMA shadows in place of the trainables (the
    reference's ``ema_scope()`` at inference)."""
    source = state.ema if state.ema is not None else state.trainable
    return merge_params(source, state.frozen)

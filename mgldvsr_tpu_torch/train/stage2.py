"""Stage-2 training: finetune the video VAE decoder's fusion and temporal
layers with the sequence-oriented LPIPS / GAN loss.

Counterpart of ``mgldvsr_tpu/train/stage2.py`` (the reference's
VideoAutoencoderKLResi training and LPIPSWithDiscriminator): a batch is LQ
frames upscaled to the GT size, GT frames, and the diffusion latents of the
LQ clip; the reconstruction is the decode of the latents with the LQ
encoder's features; the generator minimises the logvar-weighted L1 + LPIPS
NLL, plus the frame-difference and swc terms, plus the hinge GAN term with
the gradient-ratio adaptive weight; then the discriminator takes a hinge
step on the detached reconstruction. Both use Adam(b1 0.5, b2 0.9) inside
gradient accumulation (:mod:`mgldvsr_tpu_torch.train.optim`).

The generator's three gradients come from one forward, as the JAX
package's three pulls of one ``jax.vjp``: the losses are taken on a
detached copy ``r`` of the reconstruction, so LPIPS and the discriminator
are differentiated once each (d nll/dr with d nll/dlogvar, d diff/dr,
d g/dr); the decoder's last conv weight (frozen) gets the two gradients of
the adaptive weight from the decoder's last node alone, and the trainables
get theirs from one backward of the decoder with the cotangent
``d weighted/dr + scale * d g/dr`` (``scale`` = adaptive weight x warm-up
factor, detached). That is the JAX package's ``gw + scale * gl`` by
linearity.

Precision is stage 1's: float32 masters of the trainables (and logvar),
the VAE in its compute dtype, each gradient cast to float32 at once, the
masters copied into the VAE after each applied update. LPIPS, SpyNet and
the discriminator run in float32. The discriminator's parameters and
running statistics live in the state and are applied with
``torch.func.functional_call``; its BatchNorm moves the running statistics
in place. ``train_step`` updates the state's tensors in place and returns
the state; it runs cuDNN's deterministic algorithms, so that a resumed run
replays the run it continues bit for bit.

Over several ranks (``grid``, one clip a data index) a micro-step is the
JAX step on the batch of every data index's clip. Three places differ from
each rank stepping alone and averaging, all over the data group: the NLL
and frame-difference terms divide by the whole batch's rows
(``batch_ranks`` times the rank's); the adaptive weight is the ratio of the
norms of the two last-layer gradients averaged over the group; the
discriminator's training passes normalise with the whole batch's
statistics. Then the gradients of both halves are averaged over the data
group, and with ``zero1`` the optimiser states are split over the data
ranks, as in stage 1. With a tensor axis the VAE, LPIPS, SpyNet and the
discriminator are split by the JAX rule, as stage 1's towers are (the
decoder's ``conv_out``, 3 channels wide, never is: the adaptive weight
reads whole gradients).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import functional_call

from mgldvsr_tpu_torch.flow.compute import compute_clip_flows, compute_occlusion_masks
from mgldvsr_tpu_torch.flow.spynet import SpyNet
from mgldvsr_tpu_torch.models.discriminator import NLayerDiscriminator
from mgldvsr_tpu_torch.models.layers import cast_weights
from mgldvsr_tpu_torch.models.lpips import LPIPS
from mgldvsr_tpu_torch.models.vae import VideoAutoencoderKLResi, is_temporal_or_fusion
from mgldvsr_tpu_torch.parallel import mesh, tensor
from mgldvsr_tpu_torch.train import optim
from mgldvsr_tpu_torch.train.losses import (
    adaptive_d_weight,
    adopt_weight,
    hinge_d_loss,
    l1_diff,
    swc_loss,
    vanilla_d_loss,
)
from mgldvsr_tpu_torch.train.trainer import group_means

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    learning_rate: float = 5.0e-5
    grad_accum: int = 8
    disc_start: int = 501
    pixelloss_weight: float = 1.0
    diffloss_weight: float = 0.5
    temploss_weight: float = 0.5
    perceptual_weight: float = 0.5
    kl_weight: float = 0.0
    disc_weight: float = 0.025
    disc_factor: float = 1.0
    disc_loss: str = "hinge"
    logvar_init: float = 0.0
    fusion_w: float = 1.0
    num_frames: int = 5


class Stage2State(NamedTuple):
    trainable: Tensors   # float32 masters, VAE parameter names
    frozen: Tensors      # the VAE's other parameters (live, not copies)
    logvar: torch.Tensor  # float32, 0-dim
    disc: Tensors        # the discriminator's parameters and running statistics
    opt_g: dict          # optim state over the trainables and "logvar"
    opt_d: dict          # optim state over the discriminator's parameters
    step: int            # micro-steps taken


def partition_vae_params(vae: torch.nn.Module) -> Tuple[Tensors, Tensors]:
    """(trainable, frozen): the VAE's parameters (the tensors themselves).
    Stage 2 trains the decoder's temporal and fusion layers, as the JAX
    package does (:func:`~mgldvsr_tpu_torch.models.vae.is_temporal_or_fusion`)."""
    train, frozen = {}, {}
    for name, p in vae.named_parameters():
        (train if is_temporal_or_fusion(name) else frozen)[name] = p
    return train, frozen


LAST_LAYER = "decoder.conv_out.weight"  # the adaptive weight's reference layer


class Stage2Trainer:
    """Holds the VAE (the pipeline's), and frozen LPIPS and SpyNet and the
    discriminator's module, built on the VAE's device with PyTorch's
    default initialisation: fill them (``io.init_weights`` or
    ``load_state_dict``) before :meth:`init_state`, which reads the
    discriminator's weights into the state. ``grid`` and ``zero1`` as
    stage 1's trainer has them."""

    def __init__(self, vae: VideoAutoencoderKLResi, cfg: Stage2Config = Stage2Config(),
                 grid: Optional[mesh.Grid] = None, zero1: bool = False):
        self.vae = vae
        self.cfg = cfg
        self.device = next(vae.parameters()).device
        with self.device:
            self.lpips = LPIPS()
            self.disc = NLayerDiscriminator()
            self.spynet = SpyNet()
        self.opt_cfg = optim.AdamWConfig(learning_rate=cfg.learning_rate,
                                         grad_accum=cfg.grad_accum, b1=0.5, b2=0.9,
                                         weight_decay=0.0)
        self._d_loss = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
        self._vae_holds = None  # the master dict the VAE was last loaded from
        self.grid = grid
        self.group = None if grid is None else grid.data_group
        self.zero = None
        self._module_axes = None  # each module's parameters the tensor rule splits
        # the ranks whose rows make the batch the loss terms divide by
        self.batch_ranks = 1
        if grid is not None:
            shapes = {k: p.shape for k, p in partition_vae_params(vae)[0].items()}
            shapes["logvar"] = torch.Size([])
            shapes.update({k: p.shape for k, p in self.disc.named_parameters()})
            axes = {t: mesh.tensor_axes(t, m, grid.tp) for t, m in self.modules().items()}
            # the state's names: the VAE's and the discriminator's parameters
            split = {**axes["vae"], **axes["disc"]}
            self._module_axes = axes if any(axes.values()) else None
            self.zero = mesh.ZeroShard(shapes, grid.data_group, zero1,
                                       mesh.AxisSplit(split, grid.tensor_group) if split else None)
            self.batch_ranks = grid.dp

    def modules(self) -> Dict[str, torch.nn.Module]:
        """The VAE and the loss networks, by their names in the JAX state."""
        return {"vae": self.vae, "lpips": self.lpips, "disc": self.disc, "spynet": self.spynet}

    # -- state -------------------------------------------------------------

    def init_state(self) -> Stage2State:
        """Float32 masters of the VAE's trainables, read before the VAE is
        cast to its compute dtype (load float32 weights first); logvar at
        its initial value; the discriminator's tensors; zero optimiser
        states."""
        train, _ = partition_vae_params(self.vae)
        masters = {k: p.detach().float().clone() for k, p in train.items()}
        cast_weights(self.vae, self.vae.cfg.dtype)
        _, frozen = partition_vae_params(self.vae)
        logvar = torch.tensor(self.cfg.logvar_init, dtype=torch.float32, device=self.device)
        disc = {k: v.detach().float().clone() for k, v in self.disc.state_dict().items()}
        state = Stage2State(
            trainable=masters, frozen=frozen, logvar=logvar, disc=disc,
            opt_g=optim.init_opt_state({**masters, "logvar": logvar}, self.opt_cfg),
            opt_d=optim.init_opt_state(self.disc_params(disc), self.opt_cfg), step=0)
        self.load_vae(state)
        return state

    def shard(self, state: Stage2State) -> Stage2State:
        """A full state (``init_state``'s, a checkpoint's) -> this rank's.
        The first call also splits the VAE and the loss networks over the
        tensor group (after :meth:`init_state` read the discriminator)."""
        self._vae_holds = None  # a resumed state may share the start's dicts: reload
        if self.zero is None:
            return state
        if self._module_axes:
            for t, m in self.modules().items():
                tensor.shard_module(m, self._module_axes[t], self.grid)
            self._module_axes = None
            state = state._replace(frozen=partition_vae_params(self.vae)[1])
        return mesh.shard_state(state, self.zero)

    def gather(self, state: Stage2State) -> Stage2State:
        """This rank's state -> the full one, on every rank (collective)."""
        return state if self.zero is None else mesh.gather_state(state, self.zero)

    def disc_params(self, disc: Tensors) -> Tensors:
        """The discriminator's parameters among ``disc`` (no running
        statistics)."""
        names = {k for k, _ in self.disc.named_parameters()}
        return {k: v for k, v in disc.items() if k in names}

    @torch.no_grad()
    def load_vae(self, state: Stage2State) -> None:
        """Copy the masters into the VAE's compute-dtype parameters in place
        (caches keyed on a weight's version see the change)."""
        train, frozen = partition_vae_params(self.vae)
        for p in frozen.values():
            p.requires_grad_(False)
        for k, p in train.items():
            p.requires_grad_(True)
            p.copy_(state.trainable[k])
        self._vae_holds = state.trainable

    # -- the three parts of a micro-step -------------------------------------

    @torch.no_grad()
    def frozen_flows(self, gt_01: torch.Tensor):
        """SpyNet flows and occlusion masks of the GT clips (never
        differentiated): ((forward, backward), (forward occ, backward occ)),
        each [b, t-1, H, W, 2 | 1]."""
        t = self.cfg.num_frames
        clips = gt_01.reshape(gt_01.shape[0] // t, t, *gt_01.shape[1:]).float()
        ff, fb = compute_clip_flows(self.spynet, clips)
        return (ff, fb), compute_occlusion_masks(ff, fb)

    def _nll_terms(self, recon: torch.Tensor, gt: torch.Tensor, logvar: torch.Tensor):
        """(nll_loss, mean rec) on NCHW frames in [-1, 1]."""
        rec = (gt - recon).abs()
        if self.cfg.perceptual_weight > 0:
            p = self.lpips(gt, recon)
            rec = rec + self.cfg.perceptual_weight * p.reshape(-1, 1, 1, 1)
        nll = rec / torch.exp(logvar) + logvar
        # the reference: the mean over every element, over the batch rows
        # (every rank's: the rank's mean is its share of the group's mean)
        return nll.mean() / (nll.shape[0] * self.batch_ranks), rec.mean()

    def gen_step(self, state: Stage2State, lq_01: torch.Tensor, gt_01: torch.Tensor,
                 latents: torch.Tensor, flows, occs):
        """The generator half: one forward, the gradients, the update of the
        trainables and logvar. Returns (state, the detached reconstruction
        NCHW, metrics)."""
        cfg = self.cfg
        t = cfg.num_frames
        gt = (gt_01 * 2.0 - 1.0).float().permute(0, 3, 1, 2)
        lq = (lq_01 * 2.0 - 1.0).permute(0, 3, 1, 2).contiguous()
        train, frozen = partition_vae_params(self.vae)
        last_w = frozen[LAST_LAYER]
        with torch.no_grad():
            _, enc_fea = self.vae.encode(lq)
        z = latents.permute(0, 3, 1, 2).contiguous()
        disc_eval = dict(state.disc)
        last_w.requires_grad_(True)
        try:
            with torch.enable_grad():
                recon = self.vae.decode(z, enc_fea, cfg.fusion_w)
                r = recon.detach().requires_grad_(True)
                logvar = state.logvar.detach().requires_grad_(True)
                nll_loss, rec_mean = self._nll_terms(r, gt, logvar)
                r_nhwc, gt_nhwc = r.permute(0, 2, 3, 1), gt.permute(0, 2, 3, 1)
                d = l1_diff(gt_nhwc, r_nhwc, t)
                diff_term = cfg.diffloss_weight * d.mean() / (d.shape[0] * self.batch_ranks)
                temp = swc_loss(gt_nhwc, r_nhwc, t, flows, occs)
                logits_fake = functional_call(self.disc, disc_eval, (r,), {"train": False})
                g_loss = -logits_fake.mean()
                dr_nll, g_logvar = torch.autograd.grad(nll_loss, (r, logvar))
                (dr_diff,) = torch.autograd.grad(diff_term, r)
                (dr_g,) = torch.autograd.grad(g_loss, r)
                nll_w, = torch.autograd.grad(recon, last_w, dr_nll, retain_graph=True)
                g_w, = torch.autograd.grad(recon, last_w, dr_g, retain_graph=True)
                nll_w, g_w = nll_w.float(), g_w.float()
                if self.group is not None:  # the whole batch's last-layer gradients
                    both = mesh.all_reduce_mean({"nll": nll_w, "g": g_w}, self.group)
                    nll_w, g_w = both["nll"], both["g"]
                d_weight = adaptive_d_weight(nll_w.norm(), g_w.norm(), cfg.disc_weight)
                scale = d_weight * adopt_weight(cfg.disc_factor, state.step, cfg.disc_start)
                cot = (dr_nll.float() + dr_diff.float() + scale * dr_g.float()).to(r.dtype)
                names = list(train)
                got = torch.autograd.grad(recon, [train[k] for k in names], cot,
                                          allow_unused=True)
        finally:
            last_w.requires_grad_(False)
        grads = {k: (g.float() if g is not None else torch.zeros_like(state.trainable[k]))
                 for k, g in zip(names, got)}
        grads["logvar"] = g_logvar.float()
        del got, cot, recon
        if self.zero is not None:
            grads = self.zero.reduce_gradients(grads)
        with torch.no_grad():
            weighted = nll_loss.detach() + diff_term.detach() + cfg.temploss_weight * temp
            applied = optim.step(grads, state.opt_g, {**state.trainable, "logvar": state.logvar},
                                 self.opt_cfg, self.zero)
        if applied:
            self.load_vae(state)
        metrics = group_means({"loss_g": weighted + scale * g_loss.detach(),
                               "nll_loss": nll_loss.detach(), "rec_loss": rec_mean.detach(),
                               "temp_loss": temp.detach(), "g_loss": g_loss.detach()}, self.zero)
        return state, r.detach(), dict(metrics, d_weight=d_weight)

    def disc_step(self, state: Stage2State, gt_01: torch.Tensor, recon_det: torch.Tensor):
        """The discriminator half on the detached reconstruction (NCHW):
        two training passes (real, then fake, which sees the running
        statistics the first moved), the hinge loss times the warm-up
        factor, the update; ``step`` advances. Before ``disc_start`` the
        factor is 0 and the gradient exactly zero: it is not computed, and
        the optimiser's counts advance on zeros, as optax's do."""
        cfg = self.cfg
        gt = (gt_01 * 2.0 - 1.0).float().permute(0, 3, 1, 2)
        factor = adopt_weight(cfg.disc_factor, state.step, cfg.disc_start)
        params = self.disc_params(state.disc)
        live = {k: (v.detach().requires_grad_(factor != 0) if k in params else v)
                for k, v in state.disc.items()}
        passes = {"train": True, "group": self.group}
        with torch.enable_grad():
            logits_real = functional_call(self.disc, live, (gt,), passes)
            logits_fake = functional_call(self.disc, live, (recon_det,), passes)
            loss_d = factor * self._d_loss(logits_real, logits_fake)
            if factor != 0:
                got = torch.autograd.grad(loss_d, [live[k] for k in params])
                grads = {k: g.float() for k, g in zip(params, got)}
            else:
                grads = {k: torch.zeros_like(v) for k, v in params.items()}
        if self.zero is not None:
            grads = self.zero.reduce_gradients(grads)
        with torch.no_grad():
            optim.step(grads, state.opt_d, params, self.opt_cfg, self.zero)
        metrics = group_means({"loss_d": loss_d.detach(),
                               "logits_real": logits_real.detach().mean(),
                               "logits_fake": logits_fake.detach().mean()}, self.zero)
        return state._replace(step=state.step + 1), metrics

    def train_step(self, state: Stage2State, lq_01: torch.Tensor, gt_01: torch.Tensor,
                   latents: torch.Tensor) -> Tuple[Stage2State, Dict[str, Any]]:
        """One micro-step. lq_01: [(b t), H, W, 3] upscaled to the GT size,
        in [0, 1]; gt_01 the same; latents [(b t), h, w, 4] already divided
        by the diffusion scale factor (the reference's ``get_input``:
        lts / 0.18215). Returns the state (its tensors updated in place) and
        the metrics as 0-dim tensors."""
        if self._vae_holds is not state.trainable:
            self.load_vae(state)
        # cuDNN's deterministic algorithms: its default choice for some of
        # the float32 convs' backward (LPIPS, the discriminator) sums with
        # atomics, and a resumed run would not replay the straight one
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            flows, occs = self.frozen_flows(gt_01)
            state, recon_det, metrics_g = self.gen_step(state, lq_01, gt_01, latents, flows,
                                                        occs)
            state, metrics_d = self.disc_step(state, gt_01, recon_det)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        return state, {**metrics_g, **metrics_d}


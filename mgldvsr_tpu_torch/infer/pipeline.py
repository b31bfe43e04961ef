"""The MGLD-VSR restores: fixed-size segments, tiled frames of any size,
and the latent-dumping variant.

Counterpart of ``mgldvsr_tpu/infer/pipeline.py``. ``restore_segment``
VAE-encodes the (pre-upscaled) LQ frames keeping their multi-scale
features, embeds the empty prompt, computes RAFT flows and occlusion masks
at 1/8 resolution, noises the LQ latent to t=999, runs the 50-step
motion-guided sampler, decodes with the temporal decoder fusing the LQ
features, and colour-fixes. ``restore_video`` runs the reference's
``oldcanvas_tile`` protocol around ``restore_segment_canvas`` (the same
stages with the eps prediction stitched from latent tiles);
``restore_with_latents`` is the ``w_latent`` script's protocol. Frames,
latents and flows are NHWC at this boundary; the towers inside are NCHW
``nn.Module``s that hold their weights.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mgldvsr_tpu_torch.core.diffusion import (
    SamplerConfig,
    initial_latents,
    p_sample,
    sample_video,
    window_tiled_randn,
)
from mgldvsr_tpu_torch.core.schedules import DiffusionSchedule, respace_schedule
from mgldvsr_tpu_torch.flow.compute import (
    chunked_pairs,
    compute_clip_flows,
    compute_occlusion_masks,
    flows_to_latent_res,
)
from mgldvsr_tpu_torch.flow.raft import RAFT, RAFTConfig
from mgldvsr_tpu_torch.infer.canvas import ImageSpliter, make_tiled_denoise_fn
from mgldvsr_tpu_torch.infer.colorfix import apply_colorfix
from mgldvsr_tpu_torch.models.cliptext import (
    CLIPTextConfig,
    OpenCLIPTextEncoder,
    empty_prompt_tokens,
)
from mgldvsr_tpu_torch.models.layers import cast_weights
from mgldvsr_tpu_torch.models.unet import (
    InflatedUNetDualCond,
    StructCondConfig,
    StructCondEncoder,
    UNetConfig,
)
from mgldvsr_tpu_torch.models.vae import DiagonalGaussian, VAEConfig, VideoAutoencoderKLResi
from mgldvsr_tpu_torch.ops.occlusion import forward_backward_consistency_check
from mgldvsr_tpu_torch.ops.resize import resize2d
from mgldvsr_tpu_torch.parallel.sharded_sampler import rank_generator, sample_video_sharded


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_frames: int = 5
    sf: int = 4
    scale_factor: float = 0.18215
    timesteps: int = 1000
    ddpm_steps: int = 50
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    guidance_scale: float = -10.0
    guidance_mode: str = "reference"
    dec_w: float = 1.0
    colorfix: str = "adain"
    # RAFT runs at this fraction of the working resolution (1.0 = the
    # reference's fixed-script protocol)
    flow_scale: float = 1.0
    # RAFT frame pairs per call (bounds the correlation volumes' memory);
    # None or 0 = all pairs in one call
    flow_chunk_pairs: Optional[int] = 8
    # decode this many num_frames windows at a time; None = all at once
    decode_chunk_windows: Optional[int] = None
    unet: UNetConfig = UNetConfig()
    structcond: StructCondConfig = StructCondConfig()
    vae: VAEConfig = dataclasses.field(
        default_factory=lambda: VAEConfig(num_frames=5, enable_fusion=True))
    clip: CLIPTextConfig = CLIPTextConfig()
    raft: RAFTConfig = RAFTConfig()


# Device bytes one more tile-mode patch of 5 frames adds to a patch group,
# per pixel of the patch, with 2-byte (bf16) towers at the shipped widths and
# float32 RAFT: the peak of chip_smoke.py's phase-6 tile restore at two
# patches a group less its peak at one, over the patch's pixels. Measured
# 11,911 at 512x512 and 11,914 at 736x960 on an NVIDIA H100 80GB HBM3 at
# 700.00 W; rounded up to 12 KiB so the allocator's noise stays under it
# (phase 6 fails if it measures more).
PATCH_BYTES_PER_PIXEL = 12288


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class MGLDVSRPipeline:
    """Holds the five towers and the two schedules on one device.

    The towers are built with PyTorch's default initialisation; fill them
    with :func:`mgldvsr_tpu_torch.io.init_weights.init_pipeline_weights`,
    the converters of :mod:`mgldvsr_tpu_torch.io.from_jax`, or
    ``load_state_dict``, then call :meth:`cast_to_compute_dtypes`.

    The device defaults to the GPU, where the hand-written kernels run;
    without CUDA the constructor raises. ``device="cpu"`` is for parity
    tests: every kernel wrapper then takes its plain version."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "MGLDVSRPipeline runs on a CUDA device and none is available; "
                "pass device=\"cpu\" to run the plain versions on the CPU")
        with self.device:
            self.unet = InflatedUNetDualCond(cfg.unet).eval()
            self.structcond = StructCondEncoder(cfg.structcond).eval()
            self.vae = VideoAutoencoderKLResi(cfg.vae).eval()
            self.clip = OpenCLIPTextEncoder(cfg.clip).eval()
            self.raft = RAFT(cfg.raft).eval()
        self.base_sched = DiffusionSchedule.create(
            timesteps=cfg.timesteps, beta_schedule="linear", linear_start=cfg.linear_start,
            linear_end=cfg.linear_end, device=self.device)
        self.sched = respace_schedule(self.base_sched, cfg.ddpm_steps)

    def towers(self) -> Dict[str, torch.nn.Module]:
        return {"unet": self.unet, "structcond": self.structcond, "vae": self.vae,
                "clip": self.clip, "raft": self.raft}

    def cast_to_compute_dtypes(self) -> None:
        """Cast each tower's convs and linears to its config dtype (RAFT
        stays float32); norms and embeddings keep float32."""
        cfg = self.cfg
        for tower, dtype in ((self.unet, cfg.unet.dtype), (self.structcond, cfg.structcond.dtype),
                             (self.vae, cfg.vae.dtype), (self.clip, cfg.clip.dtype)):
            cast_weights(tower, dtype)

    # -- stages --------------------------------------------------------------

    @torch.no_grad()
    def encode(self, frames_pm1: torch.Tensor, generator: Optional[torch.Generator] = None,
               sample_posterior: bool = True, noise_window_tile: bool = False,
               noise: Optional[torch.Tensor] = None):
        """frames [N,H,W,3] in [-1,1] -> (scaled latent [N,h,w,4], LQ
        features: a list of NCHW maps). ``sample_posterior=False`` takes the
        posterior mode. ``noise_window_tile`` draws the posterior noise for
        one ``num_frames`` window and repeats it over the window batch: the
        draw each window would get from a solo call with the generator in
        the same state. ``noise`` ([N,h,w,4]) is the posterior draw itself
        (the trainer injects it)."""
        moments, enc_fea = self.vae.encode(_nchw(frames_pm1))
        g = DiagonalGaussian(_nhwc(moments))
        if noise is not None:
            z = g.mean + g.std * noise
        elif not sample_posterior:
            z = g.mode()
        elif noise_window_tile:
            z = g.mean + g.std * window_tiled_randn(g.mean, self.cfg.num_frames, generator)
        else:
            z = g.sample(generator)
        return self.cfg.scale_factor * z, enc_fea

    @torch.no_grad()
    def decode(self, latents: torch.Tensor, enc_fea: List[torch.Tensor],
               dec_w: Optional[float] = None,
               chunk_windows: Optional[int] = None) -> torch.Tensor:
        """latents [N,h,w,4] -> pixels [N,H,W,3] in about [-1,1].
        ``chunk_windows`` (or the config's) decodes that many windows at a
        time; temporal layers never cross windows, so the math is the same."""
        w = self.cfg.dec_w if dec_w is None else dec_w
        cw = self.cfg.decode_chunk_windows if chunk_windows is None else chunk_windows
        n = latents.shape[0]
        group = (cw or 0) * self.cfg.num_frames
        if not group or group >= n or n % group:
            group = n
        outs = []
        for s in range(0, n, group):
            # contiguous NCHW: the canvas sampler's latents are packed NHWC
            z = _nchw(latents[s:s + group] / self.cfg.scale_factor).contiguous()
            outs.append(self.vae.decode(z, [f[s:s + group] for f in enc_fea], w))
        return _nhwc(torch.cat(outs, dim=0))

    @torch.no_grad()
    def embed_empty_prompt(self, batch: int) -> torch.Tensor:
        tokens = empty_prompt_tokens(batch, self.cfg.clip.context_length, device=self.device)
        return self.clip(tokens)

    @torch.no_grad()
    def compute_flows(self, frames_01: torch.Tensor, flow_scale: Optional[float] = None,
                      flow_method: str = "bilinear"):
        """frames [B*T,H,W,3] in [0,1] -> latent-resolution flows and
        occlusion masks, ([B,T-1,h,w,2] x2, [B,T-1,h,w,1] x2); flows never
        cross window boundaries."""
        fs = self.cfg.flow_scale if flow_scale is None else flow_scale
        nf = self.cfg.num_frames
        small = frames_01
        if fs != 1.0:
            n, h, w, _ = frames_01.shape
            small = resize2d(frames_01, (int(h * fs), int(w * fs)), method=flow_method)
        n, h, w, c = small.shape
        if n % nf:
            raise ValueError(f"{n} frames is not a multiple of num_frames={nf}")
        raft_fn = chunked_pairs(self.raft, self.cfg.flow_chunk_pairs)
        ff, fb = compute_clip_flows(raft_fn, small.reshape(n // nf, nf, h, w, c))
        # contiguous, as the guidance kernels take them (a copy at most, once a segment)
        ff = flows_to_latent_res(ff, 0.125 / fs).contiguous()
        fb = flows_to_latent_res(fb, 0.125 / fs).contiguous()
        return (ff, fb), compute_occlusion_masks(ff, fb)

    def denoise_fn(self, struct_latent: torch.Tensor, context: torch.Tensor):
        """(x [N,h,w,4], t_orig [N]) -> eps [N,h,w,4] float32: struct-cond
        features of the LQ latent at t, then the UNet."""

        def fn(x, t_orig):
            return self._unet_nhwc(x, t_orig, context, self._structcond_nhwc(struct_latent, t_orig))

        return fn

    @torch.no_grad()
    def _structcond_nhwc(self, s: torch.Tensor, t_orig: torch.Tensor):
        return self.structcond(_nchw(s).contiguous(), t_orig)

    @torch.no_grad()
    def _unet_nhwc(self, x: torch.Tensor, t_orig: torch.Tensor, context: torch.Tensor, s_cond):
        # the towers take contiguous NCHW: the fixed sampler's latents are
        # NHWC views of it already, the canvas's tiles are packed NHWC
        return _nhwc(self.unet(_nchw(x).contiguous(), t_orig, context, s_cond))

    @torch.no_grad()
    def log_images(self, frames_01: torch.Tensor, generator: torch.Generator, n_row: int = 4,
                   dec_w: Optional[float] = None) -> Dict[str, torch.Tensor]:
        """The reference's training-log rows (ddpm.py:4765-4876): ``inputs``
        (the LQ clip), ``reconstruction`` (the VAE round trip with the LQ
        features), ``samples`` (the guided restore) and ``denoise_row``
        (frame 0 of ``n_row`` evenly spaced intermediate latents of the
        reverse process, decoded). All [N, H, W, 3] in [0, 1]."""
        cfg = self.cfg
        frames_pm1 = frames_01 * 2.0 - 1.0
        init_latent, enc_fea = self.encode(frames_pm1, generator)
        context = self.embed_empty_prompt(frames_01.shape[0])
        flows, masks = self.compute_flows(frames_01)
        x = initial_latents(self.base_sched, init_latent, generator)
        scfg = SamplerConfig(num_frames=cfg.num_frames, guidance_scale=cfg.guidance_scale,
                             guidance_mode=cfg.guidance_mode)
        denoise = self.denoise_fn(init_latent, context)
        inter = []
        for i in range(self.sched.num_timesteps - 1, -1, -1):
            x = p_sample(self.sched, denoise, x, i, generator, scfg, flows, masks)
            inter.append(x)
        recon = self.decode(init_latent, enc_fea, dec_w)
        samples = self.decode(x, enc_fea, dec_w)
        idxs = np.linspace(0, len(inter) - 1, n_row).astype(int)
        row = torch.stack([self.decode(inter[i], enc_fea, dec_w)[0] for i in idxs])

        def to01(v):
            return torch.clamp((v.float() + 1.0) / 2.0, 0.0, 1.0)

        return {"inputs": frames_01, "reconstruction": to01(recon), "samples": to01(samples),
                "denoise_row": to01(row)}

    # -- full restore --------------------------------------------------------

    def _restore(self, frames_01: torch.Tensor, generator: Optional[torch.Generator], *,
                 deterministic: bool, dec_w: Optional[float], guidance_scale: float,
                 flows: Optional[Callable[[], tuple]], denoise: Optional[Callable] = None,
                 window_noise: bool = False, clip01: bool = True,
                 stage_seconds: Optional[Dict[str, float]] = None,
                 sampler: Optional[Callable] = None):
        """The stages every restore runs, in order: encode, the empty
        prompt, flows, x_T, the guided sampler, decode, colour fix. ``flows``
        gives the (flows, masks) pair, or is None for no guidance;
        ``denoise(lq_latent, context)`` builds the eps function (default
        :meth:`denoise_fn`); ``sampler(denoise_fn, x_T, generator, cfg,
        flows, masks)`` gives the final latents (default :func:`sample_video`).
        Returns (frames, final latents [N,h,w,4])."""
        cfg = self.cfg
        if generator is None and not deterministic:
            raise ValueError("a restore needs a torch.Generator unless deterministic")
        clock = _StageClock(self.device, stage_seconds)
        frames_pm1 = frames_01 * 2.0 - 1.0
        init_latent, enc_fea = self.encode(frames_pm1, generator,
                                           sample_posterior=not deterministic,
                                           noise_window_tile=window_noise)
        clock.lap("encode")
        context = self.embed_empty_prompt(frames_01.shape[0])
        clock.lap("clip")
        fl, masks = flows() if flows is not None else (None, None)
        clock.lap("flows")
        if deterministic:
            xt_noise = torch.zeros_like(init_latent)
        elif window_noise:
            xt_noise = window_tiled_randn(init_latent, cfg.num_frames, generator)
        else:
            xt_noise = None
        x_T = initial_latents(self.base_sched, init_latent, generator, noise=xt_noise)
        scfg = SamplerConfig(num_frames=cfg.num_frames, guidance_scale=guidance_scale,
                             guidance_mode=cfg.guidance_mode,
                             temperature=0.0 if deterministic else 1.0,
                             noise_window_tile=window_noise)
        dn = (denoise or self.denoise_fn)(init_latent, context)
        if sampler is None:
            latents = sample_video(self.sched, dn, x_T, generator, scfg, fl, masks).latents
        else:
            latents = sampler(dn, x_T, generator, scfg, fl, masks)
        clock.lap("sampler")
        decoded = self.decode(latents, enc_fea, dec_w).float()
        fixed = apply_colorfix(decoded, frames_pm1, cfg.colorfix)
        result = torch.clamp((fixed + 1.0) / 2.0, 0.0, 1.0) if clip01 else fixed
        clock.lap("decode")
        return result, latents

    def restore_segment(self, frames_01: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        dec_w: Optional[float] = None, use_guidance: bool = True,
                        deterministic: bool = False,
                        stage_seconds: Optional[Dict[str, float]] = None) -> torch.Tensor:
        """[B*T,H,W,3] target-size frames in [0,1] -> SR frames in [0,1].

        B >= 1 windows of ``num_frames`` may be batched. ``deterministic``
        zeroes every noise draw (posterior mode, x_T noise 0, sampler
        temperature 0) and needs no generator. ``stage_seconds``, when
        given, is filled with each stage's wall seconds, the device
        synchronised at each stage boundary."""
        return self._restore(
            frames_01, generator, deterministic=deterministic, dec_w=dec_w,
            guidance_scale=self.cfg.guidance_scale,
            flows=(lambda: self.compute_flows(frames_01)) if use_guidance else None,
            stage_seconds=stage_seconds)[0]

    def restore_segment_canvas(self, frames_01: torch.Tensor,
                               generator: Optional[torch.Generator] = None, tile: int = 64,
                               tile_overlap: int = 32, batch_tiles: int = 4,
                               dec_w: Optional[float] = None, use_guidance: bool = True,
                               return_latents: bool = False, flows_masks=None,
                               deterministic: bool = False, clip01: bool = True,
                               window_noise: bool = False):
        """A segment of any size (a multiple of 32) with latent canvas
        tiling: each step's eps is the gaussian-stitched combination of the
        UNet on ``tile``-latent tiles, one trajectory for the whole canvas.

        ``flows_masks``: precomputed ``(flows, masks)`` at this segment's
        latent resolution (the tiled protocol computes them once on the
        whole frame); otherwise they are computed here. ``deterministic``
        zeroes every draw, as in ``restore_segment``. ``clip01=False``
        returns the colour-fixed frames in [-1,1] unclamped (the tiled
        protocol averages patches before it clamps). ``window_noise``: every
        draw (posterior, x_T, per step) is made for one ``num_frames``
        window and repeated over the window batch, so K patches stacked on
        the frames axis each get the draws a solo call would get.
        ``return_latents`` also returns the final latents."""
        flows = None
        if use_guidance:
            flows = ((lambda: flows_masks) if flows_masks is not None
                     else (lambda: self.compute_flows(frames_01)))

        def denoise(lq_latent, context):
            return make_tiled_denoise_fn(self._structcond_nhwc, self._unet_nhwc, lq_latent,
                                         context, tile, tile_overlap, batch_tiles)

        result, latents = self._restore(
            frames_01, generator, deterministic=deterministic, dec_w=dec_w,
            guidance_scale=self.cfg.guidance_scale, flows=flows, denoise=denoise,
            window_noise=window_noise, clip01=clip01)
        return (result, latents) if return_latents else result

    def restore_with_latents(self, frames_01: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             dec_w: Optional[float] = None, deterministic: bool = False):
        """The ``w_latent`` script's protocol; returns (frames in [0,1],
        final latents [N,h,w,4]) so the latents can be kept as stage-2
        training data. As that script does: flows at the full working
        resolution, the occlusion masks of the swapped consistency check,
        and the sampler with flows at guidance scale -1.0 (a weak
        correction, not none). ``deterministic`` zeroes every draw."""

        def flows():
            fl, masks = self.compute_flows(frames_01, flow_scale=1.0)
            return fl, (masks[1], masks[0])

        return self._restore(frames_01, generator, deterministic=deterministic, dec_w=dec_w,
                             guidance_scale=-1.0, flows=flows)

    @torch.no_grad()
    def boundary_flow(self, last: torch.Tensor, first: torch.Tensor):
        """The flow across a window boundary: ``last`` (a window's last
        frame) and ``first`` (the next window's first), [1,H,W,3] in [0,1] ->
        (bflow [1,h,w,2] at latent resolution, which warps ``first`` towards
        ``last`` as ``flows_backward`` does within a window, and its occlusion
        mask [1,h,w,1]): one RAFT call on both directions at the config's
        ``flow_scale``, then the consistency check."""
        fs = self.cfg.flow_scale
        pair = torch.cat([last, first])
        if fs != 1.0:
            _, h, w, _ = pair.shape
            pair = resize2d(pair, (int(h * fs), int(w * fs)), method="bilinear")
        both = flows_to_latent_res(self.raft(pair, pair.flip(0))[:, None], 0.125 / fs)[:, 0]
        bflow, brev = both[:1].contiguous(), both[1:].contiguous()
        return bflow, forward_backward_consistency_check(bflow, brev)[0]

    def restore_windows_sharded(self, frames_01: torch.Tensor,
                                generator: Optional[torch.Generator] = None, group=None,
                                dec_w: Optional[float] = None, boundary_weight: float = 1.0,
                                deterministic: bool = False,
                                stage_seconds: Optional[Dict[str, float]] = None) -> torch.Tensor:
        """D consecutive windows, one a rank of ``group`` (the whole world by
        default), restored with the halo-coupled sampler
        (:func:`~mgldvsr_tpu_torch.parallel.sharded_sampler.sample_video_sharded`):
        every rank is given the same [D·t,H,W,3] target-size frames in [0,1]
        and returns the SR frames [t,H,W,3] of its own window r. No frames
        cross ranks; each step sends one latent frame to the left neighbour.

        Rank r restores window r as :meth:`restore_segment` does, and adds the
        boundary pair: the flow from its last frame to window r+1's first and
        its occlusion (:meth:`boundary_flow`); the last rank gets zero flow
        and an all-occluded mask. Every rank must hold ``generator`` in the
        same state; each draws from its own (:func:`rank_generator`). At
        ``boundary_weight=0``, each window is :meth:`restore_segment`'s.
        ``deterministic`` zeroes every draw and needs no generator."""
        t = self.cfg.num_frames
        n = frames_01.shape[0]
        if n % t:
            raise ValueError(f"{n} frames is not a multiple of num_frames={t}")
        d, r = n // t, dist.get_rank(group)
        if d != dist.get_world_size(group):
            raise ValueError(f"need exactly one rank per window: {d} windows, "
                             f"{dist.get_world_size(group)} ranks")
        if generator is None and not deterministic:
            raise ValueError("a restore needs a torch.Generator unless deterministic")
        mine = frames_01[r * t:(r + 1) * t]
        boundary = {}

        def flows():
            (ff, fb), masks = self.compute_flows(mine)
            if r < d - 1:
                boundary["pair"] = self.boundary_flow(mine[-1:], frames_01[(r + 1) * t:][:1])
            else:  # no right neighbour: the term is multiplied by 0
                hl, wl = ff.shape[2:4]
                boundary["pair"] = (ff.new_zeros(1, hl, wl, 2), ff.new_ones(1, hl, wl, 1))
            return (ff, fb), masks

        def sampler(dn, x_T, gen, scfg, fl, masks):
            return sample_video_sharded(self.sched, dn, x_T, gen, scfg, fl, masks,
                                        *boundary["pair"], boundary_weight=boundary_weight,
                                        group=group)

        return self._restore(
            mine, None if deterministic else rank_generator(generator, group),
            deterministic=deterministic, dec_w=dec_w, guidance_scale=self.cfg.guidance_scale,
            flows=flows, sampler=sampler, stage_seconds=stage_seconds)[0]

    def restore_video(self, lq_frames_01: torch.Tensor,
                      generator: Optional[torch.Generator] = None, pch_size: int = 960,
                      pch_stride: int = 750, min_side: int = 512, dec_w: Optional[float] = None,
                      use_guidance: bool = True, flow_scale: float = 0.25,
                      deterministic: bool = False, tile: int = 64, tile_overlap: int = 32,
                      batch_tiles: int = 4, patch_batch: Optional[int] = None,
                      stage_seconds: Optional[Dict[str, float]] = None,
                      patch_group=None) -> torch.Tensor:
        """The reference's ``oldcanvas_tile`` protocol on one window of LQ
        frames [T,h,w,3] in [0,1]; returns the SR frames in [0,1] on the
        pipeline's device.

        One bicubic pre-upscale by max(min_side / min(h, w), sf) with
        int-truncated sizes; a reflect pad to a multiple of 32; flows once
        on the whole padded frame at ``flow_scale`` (bicubic downsize) with
        the tile script's swapped mask pair; overlapping pixel patches
        (``pch_size``/``pch_stride``) whose flows and masks are cut by an
        /8 spliter zipped by order; each patch restored by
        ``restore_segment_canvas``; the overlap-average in [-1,1], then the
        clamp; and, where the pre-upscale overshot sf, a bicubic downscale
        of the padded frame followed by the reference's pad crop (a no-op
        at that size).

        ``pch_size <= 0`` takes one canvas tile a patch (8·tile px) and a
        stride of 7/8 of it in latent units (also when an explicit stride
        would leave no overlap). Every patch gets the same draws: the
        generator's state is saved here and restored before every group of
        ``patch_batch`` patches, which ride the window axis of one call (the
        last group padded by repeating its last patch), so any
        ``patch_batch`` gives the same frames up to the towers' rounding
        (bf16 kernels may sum in another order at another batch). ``patch_batch=None`` takes
        :meth:`patch_batch_envelope`. ``stage_seconds``, when given, gets
        the seconds of ``upscale``, ``flows``, ``patches`` and ``gather``;
        with ``MGLD_PROGRESS`` set (read at the call) the JAX package's stage
        lines are printed: ``[restore_video] <stage> <s>s`` for
        ``pre-upscale+pad``, ``flows`` (with guidance) and the patch loop
        with the gather (the gather's seconds as its ``drain``).
        ``patch_group`` (a process group; every rank calls with the same
        frames and generator state) splits the patch groups over its ranks
        (:meth:`_restore_patches`): the same frames on every rank."""
        cfg = self.cfg
        t = cfg.num_frames
        if generator is None and not deterministic:
            raise ValueError("restore_video needs a torch.Generator unless deterministic")
        if lq_frames_01.shape[0] != t:
            raise ValueError(f"restore_video takes one window of {t} frames, got "
                             f"{tuple(lq_frames_01.shape)}")
        clock = _StageClock(self.device, stage_seconds,
                            "restore_video" if os.environ.get("MGLD_PROGRESS") else None)
        size_auto = pch_size <= 0
        if size_auto:
            pch_size = 8 * tile
        if pch_stride <= 0 or (size_auto and pch_stride >= pch_size):
            # in latent units, so the /8 flow spliter walks the same grid
            pch_stride = 8 * max((pch_size * 7) // 64, 1)
        _, h0, w0, _ = lq_frames_01.shape
        upsample_scale = max(min_side / min(h0, w0), float(cfg.sf))
        work_h, work_w = int(h0 * upsample_scale), int(w0 * upsample_scale)
        frames = torch.clamp(resize2d(lq_frames_01, (work_h, work_w), method="bicubic"), 0.0, 1.0)
        frames = reflect_pad(frames, (-work_h) % 32, (-work_w) % 32)
        clock.show("pre-upscale+pad", clock.lap("upscale"))

        spliter = ImageSpliter(tuple(frames.shape), pch_size, pch_stride)
        patches = [patch for patch, _ in spliter.split(frames)]
        flow_patches: list = [None] * len(patches)
        if use_guidance:
            (ff, fb), (of, ob) = self.compute_flows(frames, flow_scale=flow_scale,
                                                    flow_method="bicubic")
            # the tile script checks consistency with the flows swapped
            # against the fixed script, which swaps the resulting masks
            of, ob = ob, of
            fsplit = ImageSpliter((ff.shape[1], ff.shape[2], ff.shape[3], 2), pch_size // 8,
                                  pch_stride // 8)
            # zipped by order: extra /8 positions go unused, fewer would
            # pair patches with the wrong flows
            if len(fsplit.positions) < len(spliter.positions):
                raise ValueError(f"flow spliter produced {len(fsplit.positions)} patches for "
                                 f"{len(spliter.positions)} pixel patches")
            ph, pw = fsplit.pch_size_h, fsplit.pch_size_w
            for i, (oy, ox) in enumerate(fsplit.positions[:len(patches)]):
                flow_patches[i] = tuple(tuple(a[:, :, oy:oy + ph, ox:ox + pw] for a in pair)
                                      for pair in ((ff, fb), (of, ob)))
        secs = clock.lap("flows")
        if use_guidance:
            clock.show("flows", secs)

        if patch_batch is None:
            patch_batch = self.patch_batch_envelope(*patches[0].shape[1:3])
        state = generator.get_state() if generator is not None else None

        def restore_group(group):
            """Patches ``group`` (indices) on the window axis of one call."""
            # one concatenation a group: contiguous frames, flows and masks
            stacked = torch.cat([patches[i] for i in group], 0)
            fm = None
            if use_guidance:
                fm = tuple(tuple(torch.cat([flow_patches[i][p][d] for i in group], 0)
                                 for d in range(2)) for p in range(2))
            if state is not None:
                generator.set_state(state)
            o = self.restore_segment_canvas(
                stacked, generator, tile=tile, tile_overlap=tile_overlap,
                batch_tiles=batch_tiles, dec_w=dec_w, use_guidance=use_guidance,
                flows_masks=fm, deterministic=deterministic, clip01=False, window_noise=True)
            return [o[j * t:(j + 1) * t] for j in range(len(group))]

        outs = self._restore_patches(len(patches), restore_group, patch_batch, patch_group)
        secs = clock.lap("patches")

        full = torch.clamp((spliter.gather(outs) + 1.0) / 2.0, 0.0, 1.0)
        if upsample_scale > cfg.sf:
            # the reference downscales the padded frame, then crops the pad
            # at working size: a no-op that keeps a scaled pad remnant
            out_h = int(frames.shape[1] * cfg.sf / upsample_scale)
            out_w = int(frames.shape[2] * cfg.sf / upsample_scale)
            full = torch.clamp(resize2d(full, (out_h, out_w), method="bicubic"), 0.0, 1.0)
        full = full[:, :work_h, :work_w]
        drain = clock.lap("gather")
        if patch_group is None:
            clock.show(f"patch loop ({len(patches)}) + device gather (drain {drain:.2f}s)",
                       secs + drain)
        else:
            clock.show(f"patch loop sharded ({len(patches)} over "
                       f"{dist.get_world_size(patch_group)} devices) + device gather",
                       secs + drain)
        return full

    def _restore_patches(self, n_patches: int, restore_group: Callable, patch_batch: int,
                         group=None) -> List[torch.Tensor]:
        """The finished tile-mode patches, in order: groups of ``kb``
        patches (``restore_group(indices)``), the list padded by repeating
        the last patch to whole groups. With a process group ``group`` the
        groups are split over its ranks, padded so that every rank holds as
        many, and gathered in order on every rank; ``kb`` is then the
        smallest ``patch_batch`` of any rank (the envelope reads each card's
        free memory), at most a rank's share."""
        world, r = 1, 0
        if group is not None:
            world, r = dist.get_world_size(group), dist.get_rank(group)
            pb = torch.tensor([patch_batch], device=self.device)
            dist.all_reduce(pb, op=dist.ReduceOp.MIN, group=group)
            patch_batch = int(pb.item())
        kb = max(1, min(patch_batch, -(-n_patches // world)))
        per_rank = kb * -(-n_patches // (world * kb))
        order = list(range(n_patches)) + [n_patches - 1] * (world * per_rank - n_patches)
        mine = order[r * per_rank:(r + 1) * per_rank]
        outs = [o for g0 in range(0, per_rank, kb) for o in restore_group(mine[g0:g0 + kb])]
        if group is None:
            return outs[:n_patches]
        local = torch.stack(outs)
        gathered = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(gathered, local, group=group)
        return list(torch.cat(gathered)[:n_patches])

    def patch_batch_envelope(self, ph: int, pw: int) -> int:
        """Patches of ph x pw pixels a tile-mode group may hold: 0.8 of the
        device memory free to this process (what cudaMemGetInfo reports free
        and what the caching allocator holds unused) over the bytes a patch
        takes, ``PATCH_BYTES_PER_PIXEL · ph · pw``; at least 1.

        The constant was measured with 2-byte towers at the shipped widths
        and 5 frames. Wider tower dtypes scale it by their size (an upper
        bound: RAFT and the latents are float32 either way); other widths or
        frame counts were never measured and take 1, as does the CPU."""
        if self.device.type != "cuda" or not _measured_widths(self.cfg):
            return 1
        cfg = self.cfg
        itemsize = max(torch.finfo(d).bits // 8
                       for d in (cfg.unet.dtype, cfg.structcond.dtype, cfg.vae.dtype))
        per_patch = PATCH_BYTES_PER_PIXEL * max(itemsize, 2) // 2 * ph * pw
        free, _ = torch.cuda.mem_get_info(self.device)
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        return max(1, int(0.8 * free) // per_patch)


def _measured_widths(cfg: PipelineConfig) -> bool:
    """Whether the towers a tile-mode patch runs through have the widths and
    frame count ``PATCH_BYTES_PER_PIXEL`` was measured at (dtypes aside)."""
    ref = PipelineConfig()

    def widths(tower):
        return dataclasses.replace(tower, dtype=torch.float32)

    return cfg.num_frames == ref.num_frames and all(
        widths(getattr(cfg, n)) == widths(getattr(ref, n)) for n in ("unet", "structcond", "vae"))


def reflect_pad(frames: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Pad [T,H,W,C] at the bottom and right by reflection without the edge
    (``numpy.pad(mode="reflect")``, which reflects again where the pad
    exceeds the side)."""
    if pad_h:
        rows = np.pad(np.arange(frames.shape[1]), (0, pad_h), mode="reflect")
        frames = frames[:, torch.from_numpy(rows).to(frames.device)]
    if pad_w:
        cols = np.pad(np.arange(frames.shape[2]), (0, pad_w), mode="reflect")
        frames = frames[:, :, torch.from_numpy(cols).to(frames.device)]
    return frames


class _StageClock:
    """Wall seconds per stage, synchronising the device at each lap, into
    ``out``; with ``progress`` (a method's name) :meth:`show` prints a stage
    line ``[progress] <stage> <s>s``. Does nothing without either."""

    def __init__(self, device: torch.device, out: Optional[Dict[str, float]],
                 progress: Optional[str] = None):
        self.device = device
        self.out = out
        self.progress = progress
        self.on = out is not None or progress is not None
        self.t = time.perf_counter() if self.on else 0.0

    def lap(self, name: str) -> float:
        """The seconds since the last lap (0.0 when off)."""
        if not self.on:
            return 0.0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        secs, self.t = now - self.t, now
        if self.out is not None:
            self.out[name] = secs
        return secs

    def show(self, stage: str, secs: float) -> None:
        if self.progress is not None:
            print(f"[{self.progress}] {stage} {secs:.2f}s", flush=True)


def upscale_frames(frames_01: torch.Tensor, sf: int = 4) -> torch.Tensor:
    """Bicubic pre-upscale of LQ frames [T,H,W,C] to the target size."""
    t, h, w, c = frames_01.shape
    return torch.clamp(resize2d(frames_01, (h * sf, w * sf), method="bicubic"), 0.0, 1.0)

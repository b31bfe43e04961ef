"""The fixed-size MGLD-VSR restore of one segment.

Counterpart of ``mgldvsr_tpu/infer/pipeline.py`` (``restore_segment`` and
the stages it runs): VAE-encode the (pre-upscaled) LQ frames keeping their
multi-scale features, embed the empty prompt, compute RAFT flows and
occlusion masks at 1/8 resolution, noise the LQ latent to t=999, run the
50-step motion-guided sampler, decode with the temporal decoder fusing the
LQ features, and colour-fix. Frames, latents and flows are NHWC at this
boundary; the towers inside are NCHW ``nn.Module``s that hold their
weights.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from mgldvsr_tpu_torch.core.diffusion import SamplerConfig, initial_latents, sample_video
from mgldvsr_tpu_torch.core.schedules import DiffusionSchedule, respace_schedule
from mgldvsr_tpu_torch.flow.compute import (
    chunked_pairs,
    compute_clip_flows,
    compute_occlusion_masks,
    flows_to_latent_res,
)
from mgldvsr_tpu_torch.flow.raft import RAFT, RAFTConfig
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
from mgldvsr_tpu_torch.ops.resize import resize2d


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
    # None = all pairs in one call
    flow_chunk_pairs: Optional[int] = 8
    # decode this many num_frames windows at a time; None = all at once
    decode_chunk_windows: Optional[int] = None
    unet: UNetConfig = UNetConfig()
    structcond: StructCondConfig = StructCondConfig()
    vae: VAEConfig = dataclasses.field(
        default_factory=lambda: VAEConfig(num_frames=5, enable_fusion=True))
    clip: CLIPTextConfig = CLIPTextConfig()
    raft: RAFTConfig = RAFTConfig()


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
               sample_posterior: bool = True):
        """frames [N,H,W,3] in [-1,1] -> (scaled latent [N,h,w,4], LQ
        features: a list of NCHW maps). ``sample_posterior=False`` takes the
        posterior mode."""
        moments, enc_fea = self.vae.encode(_nchw(frames_pm1))
        g = DiagonalGaussian(_nhwc(moments))
        z = g.sample(generator) if sample_posterior else g.mode()
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
            z = _nchw(latents[s:s + group] / self.cfg.scale_factor)
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
        raft_fn = self.raft
        if self.cfg.flow_chunk_pairs is not None:
            raft_fn = chunked_pairs(raft_fn, self.cfg.flow_chunk_pairs)
        ff, fb = compute_clip_flows(raft_fn, small.reshape(n // nf, nf, h, w, c))
        ff = flows_to_latent_res(ff, 0.125 / fs)
        fb = flows_to_latent_res(fb, 0.125 / fs)
        return (ff, fb), compute_occlusion_masks(ff, fb)

    def denoise_fn(self, struct_latent: torch.Tensor, context: torch.Tensor):
        """(x [N,h,w,4], t_orig [N]) -> eps [N,h,w,4] float32: struct-cond
        features of the LQ latent at t, then the UNet."""
        s_in = _nchw(struct_latent)

        @torch.no_grad()
        def fn(x, t_orig):
            s_cond = self.structcond(s_in, t_orig)
            return _nhwc(self.unet(_nchw(x), t_orig, context, s_cond))

        return fn

    # -- full restore --------------------------------------------------------

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
        cfg = self.cfg
        if generator is None and not deterministic:
            raise ValueError("restore_segment needs a torch.Generator unless deterministic")
        clock = _StageClock(self.device, stage_seconds)
        frames_pm1 = frames_01 * 2.0 - 1.0
        init_latent, enc_fea = self.encode(frames_pm1, generator,
                                           sample_posterior=not deterministic)
        clock.lap("encode")
        context = self.embed_empty_prompt(frames_01.shape[0])
        clock.lap("clip")
        flows, masks = self.compute_flows(frames_01) if use_guidance else (None, None)
        clock.lap("flows")
        x_T = initial_latents(self.base_sched, init_latent, generator,
                              noise=torch.zeros_like(init_latent) if deterministic else None)
        scfg = SamplerConfig(num_frames=cfg.num_frames, guidance_scale=cfg.guidance_scale,
                             guidance_mode=cfg.guidance_mode,
                             temperature=0.0 if deterministic else 1.0)
        out = sample_video(self.sched, self.denoise_fn(init_latent, context), x_T,
                           generator, scfg, flows, masks)
        clock.lap("sampler")
        decoded = self.decode(out.latents, enc_fea, dec_w).float()
        fixed = apply_colorfix(decoded, frames_pm1, cfg.colorfix)
        result = torch.clamp((fixed + 1.0) / 2.0, 0.0, 1.0)
        clock.lap("decode")
        return result


class _StageClock:
    """Wall seconds per stage, synchronising the device at each lap; does
    nothing when no dict is given."""

    def __init__(self, device: torch.device, out: Optional[Dict[str, float]]):
        self.device = device
        self.out = out
        self.t = time.perf_counter() if out is not None else 0.0

    def lap(self, name: str) -> None:
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = now - self.t
        self.t = now


def upscale_frames(frames_01: torch.Tensor, sf: int = 4) -> torch.Tensor:
    """Bicubic pre-upscale of LQ frames [T,H,W,C] to the target size."""
    t, h, w, c = frames_01.shape
    return torch.clamp(resize2d(frames_01, (h * sf, w * sf), method="bicubic"), 0.0, 1.0)

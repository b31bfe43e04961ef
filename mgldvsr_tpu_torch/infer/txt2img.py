"""The stock latent-diffusion text-to-image pipeline.

Counterpart of ``mgldvsr_tpu/infer/txt2img.py`` (the reference's image
``LatentDiffusion`` with its DDIM / PLMS samplers and classifier-free
guidance): the OpenCLIP text tower, the stock UNet (the dual-cond UNet with
neither SPADE nor temporal layers), eps sampling over the base schedule and
the image VAE's decode at the scale factor 0.18215. Under guidance the
conditional and unconditional branches run as one UNet call on the doubled
batch. Latents and images are NHWC at every method's boundary, as in JAX;
the towers run NCHW inside. Gated attention calls take the attention
kernel through :func:`mgldvsr_tpu_torch.ops.attention.attend`, and every
GroupNorm the GroupNorm kernels, as in the restore.

The towers are built with PyTorch's default initialisation: fill them
(``io.init_weights.init_module_weights``, ``io.from_jax``'s
``unet_state_dict`` / ``vae_state_dict`` / ``clip_state_dict``, or
``load_state_dict``), then call :meth:`Text2ImgPipeline.cast_to_compute_dtypes`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from mgldvsr_tpu_torch.core.samplers import ddim_invert, ddim_sample, plms_sample
from mgldvsr_tpu_torch.core.schedules import DiffusionSchedule
from mgldvsr_tpu_torch.infer.pipeline import _nchw, _nhwc
from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig, OpenCLIPTextEncoder
from mgldvsr_tpu_torch.models.layers import cast_weights
from mgldvsr_tpu_torch.models.unet import InflatedUNetDualCond, UNetConfig
from mgldvsr_tpu_torch.models.vae import AutoencoderKL, DiagonalGaussian, VAEConfig


def text2img_unet_config(dtype: torch.dtype = torch.float32) -> UNetConfig:
    """SD 2.1's text-to-image denoiser: the stock ``UNetModel``."""
    return UNetConfig(use_temporal=False, use_spade=False, num_frames=1, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class Text2ImgConfig:
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.012
    scale_factor: float = 0.18215
    unet: UNetConfig = dataclasses.field(default_factory=text2img_unet_config)
    vae: VAEConfig = dataclasses.field(
        default_factory=lambda: VAEConfig(num_frames=1, enable_fusion=False))
    clip: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)


class Text2ImgPipeline:
    """The three towers and the schedule on one device (default the GPU,
    where the kernels run; without CUDA the constructor raises)."""

    def __init__(self, cfg: Text2ImgConfig = Text2ImgConfig(),
                 device: torch.device | str = "cuda"):
        if cfg.unet.use_spade or cfg.unet.use_temporal:
            raise ValueError("text to image takes the stock UNet: use_spade=False, "
                             "use_temporal=False")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Text2ImgPipeline runs on a CUDA device and none is available; "
                               "pass device=\"cpu\" to run the plain versions on the CPU")
        with self.device:
            self.unet = InflatedUNetDualCond(cfg.unet).eval()
            self.vae = AutoencoderKL(cfg.vae).eval()
            self.clip = OpenCLIPTextEncoder(cfg.clip).eval()
        self.sched = DiffusionSchedule.create(
            timesteps=cfg.timesteps, beta_schedule="linear", linear_start=cfg.linear_start,
            linear_end=cfg.linear_end, device=self.device)

    def towers(self) -> Dict[str, torch.nn.Module]:
        return {"unet": self.unet, "vae": self.vae, "clip": self.clip}

    def cast_to_compute_dtypes(self) -> None:
        """Each tower's convs and linears in its config dtype."""
        for tower, dtype in ((self.unet, self.cfg.unet.dtype), (self.vae, self.cfg.vae.dtype),
                             (self.clip, self.cfg.clip.dtype)):
            cast_weights(tower, dtype)

    @torch.no_grad()
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, L] -> context [B, L, width] float32."""
        return self.clip(tokens.to(self.device, torch.int64))

    def denoise_fn(self, context: torch.Tensor, uncond_context: Optional[torch.Tensor] = None,
                   cfg_scale: float = 1.0) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """eps(x [B,h,w,4], t [B]) -> [B,h,w,4] float32; with
        ``uncond_context`` and ``cfg_scale`` != 1, classifier-free guidance
        from one UNet call on the doubled batch (unconditional first)."""
        unet = self.unet
        if uncond_context is None or cfg_scale == 1.0:
            @torch.no_grad()
            def fn(x, tb):
                return _nhwc(unet(_nchw(x), tb, context, None))
            return fn
        ctx2 = torch.cat([uncond_context, context], dim=0)

        @torch.no_grad()
        def guided(x, tb):
            eps2 = _nhwc(unet(_nchw(torch.cat([x, x], dim=0)), torch.cat([tb, tb], dim=0), ctx2,
                              None))
            eps_u, eps_c = eps2.chunk(2, dim=0)
            return eps_u + cfg_scale * (eps_c - eps_u)
        return guided

    @torch.no_grad()
    def sample_latents(self, context: torch.Tensor, generator: Optional[torch.Generator] = None,
                       height: int = 512, width: int = 512, num_steps: int = 50,
                       sampler: str = "ddim", eta: float = 0.0, cfg_scale: float = 1.0,
                       uncond_context: Optional[torch.Tensor] = None,
                       x_T: Optional[torch.Tensor] = None,
                       noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Latents [B, height/8, width/8, 4] from ``x_T`` (drawn from
        ``generator`` when not given) by DDIM or PLMS; ``noises`` are
        DDIM's draws for ``eta`` > 0, one a step."""
        b = context.shape[0]
        if x_T is None:
            x_T = torch.randn((b, height // 8, width // 8, 4), generator=generator,
                              device=self.device)
        fn = self.denoise_fn(context, uncond_context, cfg_scale)
        if sampler == "ddim":
            return ddim_sample(self.sched, fn, x_T.to(self.device), generator,
                               num_steps=num_steps, eta=eta, noises=noises)
        if sampler == "plms":
            return plms_sample(self.sched, fn, x_T.to(self.device), num_steps=num_steps)
        raise ValueError(f"unknown sampler {sampler!r}")

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents [B,h,w,4] -> images [B,8h,8w,3] float32."""
        return _nhwc(self.vae.decode(_nchw(latents / self.cfg.scale_factor))).float()

    @torch.no_grad()
    def encode(self, images_pm1: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Images [B,H,W,3] in [-1, 1] -> scaled latents [B,H/8,W/8,4]: a
        posterior sample, its noise drawn from ``generator`` or given."""
        moments = _nhwc(self.vae.encode_moments(_nchw(images_pm1.to(self.device)))).float()
        g = DiagonalGaussian(moments)
        z = g.sample(generator) if noise is None else g.mean + g.std * noise.to(g.mean)
        return self.cfg.scale_factor * z

    @torch.no_grad()
    def invert(self, images_pm1: torch.Tensor, context: torch.Tensor,
               generator: Optional[torch.Generator] = None, num_steps: int = 50,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """DDIM inversion of images into noise latents."""
        z0 = self.encode(images_pm1, generator, noise)
        return ddim_invert(self.sched, self.denoise_fn(context), z0, num_steps=num_steps)

    @torch.no_grad()
    def generate(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None,
                 uncond_tokens: Optional[torch.Tensor] = None, cfg_scale: float = 1.0,
                 **kwargs) -> torch.Tensor:
        """tokens [B, L] -> images [B,H,W,3] in about [-1, 1]."""
        context = self.embed_tokens(tokens)
        uncond = self.embed_tokens(uncond_tokens) if uncond_tokens is not None else None
        lat = self.sample_latents(context, generator, cfg_scale=cfg_scale,
                                  uncond_context=uncond, **kwargs)
        return self.decode(lat)

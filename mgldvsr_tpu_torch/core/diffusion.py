"""Motion-guided respaced DDPM sampling.

Counterpart of ``mgldvsr_tpu/core/diffusion.py``. The JAX ``lax.scan`` over
timesteps is a Python loop here. The guidance step needs the gradient of
the flow-warp temporal loss (``temporal_warp_loss``, which lives beside its
kernels in ``ops/kernels/guidance.py``) with respect to the latents alone:
``guidance_grad`` computes it as a plain function, two kernel launches on
the card and autograd through the plain warp on the CPU. The denoiser runs
without gradients.

Latents are NHWC ``[(b t), h, w, c]`` and flows ``[b, t-1, h, w, 2]``, as in
the JAX package. ``mode="reference"`` keeps the reference loop's quirks
exactly: its first term compares against a zero placeholder and its warp
is one step stale. The guidance gradient is scaled by the window count so
each window of a batched call gets the correction a lone window would.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from mgldvsr_tpu_torch.core.schedules import (
    DiffusionSchedule,
    predict_start_from_noise,
    q_posterior,
    q_sample,
)
# temporal_warp_loss is re-exported: this module is the JAX one's counterpart
from mgldvsr_tpu_torch.ops.kernels.guidance import guidance_grad, temporal_warp_loss  # noqa: F401


def adaptive_instance_normalization(content: torch.Tensor, style: torch.Tensor,
                                    eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, channel) moment transfer over H, W of NHWC tensors,
    with the unbiased variance of ``torch.Tensor.var``."""

    def mean_std(x):
        m = x.mean(dim=(1, 2), keepdim=True)
        n = x.shape[1] * x.shape[2]
        v = ((x - m) ** 2).sum(dim=(1, 2), keepdim=True) / max(n - 1, 1)
        return m, torch.sqrt(v + eps)

    c_mean, c_std = mean_std(content)
    s_mean, s_std = mean_std(style)
    return (content - c_mean) / c_std * s_std + s_mean


class SamplerOutput(NamedTuple):
    latents: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_frames: int = 5
    guidance_scale: float = -10.0
    guidance_mode: str = "reference"
    temperature: float = 1.0
    # Draw the per-step noise for ONE num_frames window and repeat it over
    # the window batch: K patches stacked on the window axis then each get
    # the draw a solo call would get from the generator in the same state
    # (the tiled restore re-seeds every patch alike)
    noise_window_tile: bool = False


def p_mean_variance(sched: DiffusionSchedule, denoise_fn: Callable, x: torch.Tensor, i: int):
    """Posterior at respaced step ``i`` of an eps-predicting denoiser, which
    gets the original timestep ``timestep_map[i]``."""
    t_orig = sched.timestep_map[i]
    eps = denoise_fn(x, t_orig.expand(x.shape[0]))
    return q_posterior(sched, predict_start_from_noise(sched, x, i, eps), x, i)


def _randn(shape, like: torch.Tensor, generator: Optional[torch.Generator]):
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def window_tiled_randn(like: torch.Tensor, num_frames: int,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """One [num_frames, ...] draw repeated over the windows of ``like``
    ([(b t), ...])."""
    base = _randn((num_frames, *like.shape[1:]), like, generator)
    return base.repeat(like.shape[0] // num_frames, *([1] * (like.ndim - 1)))


def p_sample(sched: DiffusionSchedule, denoise_fn: Callable, x: torch.Tensor, i: int,
             generator: Optional[torch.Generator], cfg: SamplerConfig,
             flows=None, masks=None, noise: Optional[torch.Tensor] = None,
             extra_grad: Optional[Callable[[torch.Tensor], Optional[torch.Tensor]]] = None
             ) -> torch.Tensor:
    """Posterior sample at step ``i`` plus the motion-guided correction.
    ``noise`` overrides the draw (tests inject it). ``extra_grad(latents)``
    gives a gradient to add to the guidance gradient, or None (the
    window-parallel sampler's boundary term)."""
    mean, _, log_var = p_mean_variance(sched, denoise_fn, x, i)
    if noise is None:
        if cfg.temperature == 0:
            noise = torch.zeros_like(x)  # the draw would be scaled to zero
        elif cfg.noise_window_tile:
            noise = window_tiled_randn(x, cfg.num_frames, generator)
        else:
            noise = _randn(tuple(x.shape), x, generator)
    noise = noise * cfg.temperature
    nonzero = float(i > 0)
    latents = mean + nonzero * torch.exp(0.5 * log_var) * noise
    if flows is not None:
        extra = extra_grad(latents) if extra_grad is not None else None
        grad = guidance_grad(latents, flows, masks, cfg.num_frames, cfg.guidance_mode)
        if extra is not None:
            grad = grad + extra
        n_windows = latents.shape[0] // cfg.num_frames
        latents = latents - cfg.guidance_scale * log_var * (n_windows * grad)
    return latents


def sample_video(sched: DiffusionSchedule, denoise_fn: Callable, x_T: torch.Tensor,
                 generator: Optional[torch.Generator], cfg: SamplerConfig,
                 flows=None, masks=None, adain_fea: Optional[torch.Tensor] = None,
                 start_T: Optional[int] = None,
                 noises: Optional[torch.Tensor] = None) -> SamplerOutput:
    """The respaced reverse process, highest step first. ``start_T`` skips
    steps whose original timestep exceeds it; ``noises`` ([steps, ...])
    overrides the per-step draws."""
    steps = list(range(sched.num_timesteps - 1, -1, -1))
    if start_T is not None:
        tmap = sched.timestep_map.cpu().numpy()
        steps = [i for i in steps if int(tmap[i]) <= start_T]
    x = x_T
    for s, i in enumerate(steps):
        x = p_sample(sched, denoise_fn, x, i, generator, cfg, flows, masks,
                     None if noises is None else noises[s])
    if adain_fea is not None:
        x = adaptive_instance_normalization(x, adain_fea)
    return SamplerOutput(latents=x)


def initial_latents(base_sched: DiffusionSchedule, z_lq: torch.Tensor,
                    generator: Optional[torch.Generator], t_start: int = 999,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_T = q_sample(z_lq, t_start) under the original schedule; ``noise``
    overrides the draw."""
    if noise is None:
        noise = _randn(tuple(z_lq.shape), z_lq, generator)
    t = torch.full((z_lq.shape[0],), t_start, dtype=torch.int64, device=z_lq.device)
    return q_sample(base_sched, z_lq, t, noise)


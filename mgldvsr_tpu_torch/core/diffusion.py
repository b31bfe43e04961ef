"""Motion-guided respaced DDPM sampling.

Counterpart of ``mgldvsr_tpu/core/diffusion.py``. The JAX ``lax.scan`` over
timesteps is a Python loop here. The guidance step differentiates the
flow-warp temporal loss with respect to the latents alone, through
``torch.autograd.grad``; the denoiser itself runs without gradients.

Latents are NHWC ``[(b t), h, w, c]`` and flows ``[b, t-1, h, w, 2]``, as in
the JAX package. ``mode="reference"`` keeps the reference loop's quirks
exactly: its first term compares against a zero placeholder and its warp
is one step stale. The guidance gradient is scaled by the window count so
each window of a batched call gets the correction a lone window would.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from mgldvsr_tpu_torch.core.schedules import (
    DiffusionSchedule,
    predict_start_from_noise,
    q_posterior,
    q_sample,
)
from mgldvsr_tpu_torch.ops.kernels.flow_warp import flow_warp_guided


def temporal_warp_loss(
    latents: torch.Tensor,
    flows: Tuple[torch.Tensor, torch.Tensor],
    occs: Tuple[torch.Tensor, torch.Tensor],
    num_frames: int,
    mode: str = "reference",
) -> torch.Tensor:
    """Bidirectional occlusion-masked flow-warp L1 over a clip's latents.

    latents [(b t), h, w, c]; flows = (forward, backward) each
    [b, t-1, h, w, 2]; occs = (fwd, bwd) each [b, t-1, h, w, 1], 1 =
    occluded. Returns the scalar sum of per-pair mean-L1 terms."""
    flow_fwd, flow_bwd = flows
    fwd_occs, bwd_occs = occs
    t = num_frames
    b = latents.shape[0] // t
    lat = latents.reshape(b, t, *latents.shape[1:])

    def l1(a, y):
        return torch.mean(torch.abs(a - y))

    loss = torch.zeros((), dtype=torch.float32, device=latents.device)
    if mode == "reference":
        # all 2(t-2) warps in one call: wb[j] = warp(l_j, fb[j]) and
        # wf[j] = warp(l_j, ff[j-1]) for j in 1..t-2
        wb, wf = {}, {}
        if t > 2:
            js = list(range(1, t - 1))
            src = torch.cat([lat[:, j] for j in js] + [lat[:, j] for j in js], dim=0)
            flo = torch.cat([flow_bwd[:, j] for j in js]
                            + [flow_fwd[:, j - 1] for j in js], dim=0)
            warped = flow_warp_guided(src, flo)
            nb = b * len(js)
            wb = {j: warped[i * b:(i + 1) * b] for i, j in enumerate(js)}
            wf = {j: warped[nb + i * b:nb + (i + 1) * b] for i, j in enumerate(js)}
        zeros = torch.zeros_like(lat[:, 0])
        for k in range(t - 2, -1, -1):
            m = 1.0 - fwd_occs[:, k]
            loss = loss + l1(m * wb.get(k + 1, zeros), m * lat[:, k])
        for k in range(1, t):
            n = 1.0 - bwd_occs[:, k - 1]
            loss = loss + l1(n * wf.get(k - 1, zeros), n * lat[:, k])
    elif mode == "aligned":
        src = torch.cat([lat[:, k + 1] for k in range(t - 1)]
                        + [lat[:, k] for k in range(t - 1)], dim=0)
        flo = torch.cat([flow_bwd[:, k] for k in range(t - 1)]
                        + [flow_fwd[:, k] for k in range(t - 1)], dim=0)
        warped = flow_warp_guided(src, flo)
        nb = b * (t - 1)
        for k in range(t - 1):
            m = 1.0 - fwd_occs[:, k]
            loss = loss + l1(m * warped[k * b:(k + 1) * b], m * lat[:, k])
            n = 1.0 - bwd_occs[:, k]
            loss = loss + l1(n * warped[nb + k * b:nb + (k + 1) * b], n * lat[:, k + 1])
    else:
        raise ValueError(f"unknown temporal loss mode {mode!r}")
    return loss


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


def p_mean_variance(sched: DiffusionSchedule, denoise_fn: Callable, x: torch.Tensor, i: int):
    """Posterior at respaced step ``i`` of an eps-predicting denoiser, which
    gets the original timestep ``timestep_map[i]``."""
    t_orig = sched.timestep_map[i]
    eps = denoise_fn(x, t_orig.expand(x.shape[0]))
    return q_posterior(sched, predict_start_from_noise(sched, x, i, eps), x, i)


def _randn(shape, like: torch.Tensor, generator: Optional[torch.Generator]):
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def p_sample(sched: DiffusionSchedule, denoise_fn: Callable, x: torch.Tensor, i: int,
             generator: Optional[torch.Generator], cfg: SamplerConfig,
             flows=None, masks=None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Posterior sample at step ``i`` plus the motion-guided correction.
    ``noise`` overrides the draw (tests inject it)."""
    mean, _, log_var = p_mean_variance(sched, denoise_fn, x, i)
    if noise is None:
        if cfg.temperature == 0:
            noise = torch.zeros_like(x)  # the draw would be scaled to zero
        else:
            noise = _randn(tuple(x.shape), x, generator)
    noise = noise * cfg.temperature
    nonzero = float(i > 0)
    latents = mean + nonzero * torch.exp(0.5 * log_var) * noise
    if flows is not None:
        with torch.enable_grad():
            lat = latents.detach().requires_grad_(True)
            loss = temporal_warp_loss(lat, flows, masks, cfg.num_frames, cfg.guidance_mode)
            (grad,) = torch.autograd.grad(loss, lat)
        n_windows = latents.shape[0] // cfg.num_frames
        latents = latents - cfg.guidance_scale * log_var * (n_windows * grad)
    return latents.detach()


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


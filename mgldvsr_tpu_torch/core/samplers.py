"""The stock DDIM and PLMS samplers and DDIM inversion.

Counterpart of ``mgldvsr_tpu/core/samplers.py`` (the reference's
``DDIMSampler`` and ``PLMSSampler``), kept for the image-LDM surface; the
restore runs the respaced DDPM loop of :mod:`mgldvsr_tpu_torch.core.diffusion`.
A Python loop over the steps, with ``denoise_fn(x, t_batch) -> eps``. The
step grid is the JAX package's ``range(0, n, n // steps)``, without the +1
that upstream's ``make_ddim_timesteps`` adds.

DDIM with ``eta > 0`` draws its noise from ``generator`` (on ``x``'s
device), or takes it from ``noises``, one tensor a step in the order the
steps run (the tests inject the JAX package's draws).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mgldvsr_tpu_torch.core.schedules import DiffusionSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_ddim_timesteps(num_ddpm: int, num_ddim: int) -> np.ndarray:
    """The uniform step grid ``range(0, num_ddpm, num_ddpm // num_ddim)``."""
    c = num_ddpm // num_ddim
    return np.asarray(list(range(0, num_ddpm, c)))


def _alphas(sched: DiffusionSchedule, steps: np.ndarray):
    """alphas_cumprod at each step and at the step before it (1 before the
    first), as float32 tensors."""
    ac = sched.alphas_cumprod
    prev = torch.cat([ac.new_ones(1), ac[torch.as_tensor(steps[:-1], device=ac.device)]])
    return ac, prev


def _tb(x: torch.Tensor, t: int) -> torch.Tensor:
    return torch.full((x.shape[0],), int(t), dtype=torch.int64, device=x.device)


def ddim_sample(sched: DiffusionSchedule, denoise_fn: DenoiseFn, x_T: torch.Tensor,
                generator: Optional[torch.Generator] = None, num_steps: int = 50,
                eta: float = 0.0, clip_denoised: bool = False,
                noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Deterministic (``eta`` = 0) or stochastic DDIM over the step grid,
    from ``x_T`` down to x_0."""
    steps = make_ddim_timesteps(sched.num_timesteps, num_steps)
    ac, ac_prev = _alphas(sched, steps)
    x = x_T
    for k, i in enumerate(range(len(steps) - 1, -1, -1)):
        t = int(steps[i])
        eps = denoise_fn(x, _tb(x, t))
        a_t, a_prev = ac[t], ac_prev[i]
        pred_x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        if clip_denoised:
            pred_x0 = pred_x0.clamp(-1, 1)
        sigma = eta * torch.sqrt((1 - a_prev) / (1 - a_t)) * torch.sqrt(1 - a_t / a_prev)
        dir_xt = torch.sqrt(torch.clamp(1 - a_prev - sigma ** 2, min=0.0)) * eps
        x = torch.sqrt(a_prev) * pred_x0 + dir_xt
        if eta:
            noise = noises[k] if noises is not None else torch.randn(
                x.shape, generator=generator, dtype=x.dtype, device=x.device)
            x = x + sigma * noise.to(x.device, x.dtype)
    return x


def ddim_invert(sched: DiffusionSchedule, denoise_fn: DenoiseFn, x_0: torch.Tensor,
                num_steps: int = 50) -> torch.Tensor:
    """Deterministic DDIM inversion: the eta = 0 update run forward, from
    ``x_0`` to the x_T whose :func:`ddim_sample` trajectory lands on it
    (eps taken at the less noisy point of each step)."""
    steps = make_ddim_timesteps(sched.num_timesteps, num_steps)
    ac, ac_prev = _alphas(sched, steps)
    x = x_0
    for i in range(len(steps)):
        t = int(steps[i])
        eps = denoise_fn(x, _tb(x, t))
        a_t, a_prev = ac[t], ac_prev[i]
        pred_x0 = (x - torch.sqrt(1 - a_prev) * eps) / torch.sqrt(a_prev)
        x = torch.sqrt(a_t) * pred_x0 + torch.sqrt(1 - a_t) * eps
    return x


def plms_sample(sched: DiffusionSchedule, denoise_fn: DenoiseFn, x_T: torch.Tensor,
                num_steps: int = 50, clip_denoised: bool = False) -> torch.Tensor:
    """Pseudo linear multistep (deterministic): each step's eps is the
    Adams-Bashforth combination of this and up to three earlier evaluations."""
    steps = make_ddim_timesteps(sched.num_timesteps, num_steps)
    ac, ac_prev = _alphas(sched, steps)
    x, old = x_T, []
    for i in range(len(steps) - 1, -1, -1):
        t = int(steps[i])
        eps = denoise_fn(x, _tb(x, t))
        if not old:
            eps_prime = eps
        elif len(old) == 1:
            eps_prime = (3 * eps - old[0]) / 2
        elif len(old) == 2:
            eps_prime = (23 * eps - 16 * old[0] + 5 * old[1]) / 12
        else:
            eps_prime = (55 * eps - 59 * old[0] + 37 * old[1] - 9 * old[2]) / 24
        a_t, a_prev = ac[t], ac_prev[i]
        pred_x0 = (x - torch.sqrt(1 - a_t) * eps_prime) / torch.sqrt(a_t)
        if clip_denoised:
            pred_x0 = pred_x0.clamp(-1, 1)
        x = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1 - a_prev) * eps_prime
        old = [eps] + old[:2]
    return x

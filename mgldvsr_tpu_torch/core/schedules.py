"""Diffusion (DDPM) schedule math and timestep respacing.

Counterpart of ``mgldvsr_tpu/core/schedules.py``: the schedule is built in
float64 numpy exactly as there, then stored as float32 tensors on a device.
``timestep_map[i]`` maps a respaced index back to the original process
index, which the UNet and struct-cond encoder receive.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """``linear`` is Stable Diffusion's sqrt-space linspace; ``cosine`` is
    the improved-DDPM schedule."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], a_min=0.0, a_max=0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas.astype(np.float64)


def space_timesteps(num_timesteps: int, section_counts) -> list[int]:
    """IDDPM respacing: the sorted original indices to keep. Accepts a list
    of per-section counts, ``"ddimN"`` or comma-separated counts."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired_count:
                    return list(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: list[int] = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1.0 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return sorted(set(all_steps))


_FIELDS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2", "lvlb_weights",
)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All derived DDPM quantities as float32 tensors on one device;
    ``timestep_map`` is int64."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    lvlb_weights: torch.Tensor
    timestep_map: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})

    @classmethod
    def create(
        cls,
        *,
        device: torch.device | str,
        timesteps: int = 1000,
        beta_schedule: str = "linear",
        linear_start: float = 0.00085,
        linear_end: float = 0.0120,
        cosine_s: float = 8e-3,
        given_betas: np.ndarray | None = None,
        v_posterior: float = 0.0,
        parameterization: str = "eps",
        timestep_map: Sequence[int] | None = None,
    ) -> "DiffusionSchedule":
        """``device`` has no default: the caller says where the tensors
        live (the pipeline passes its own device)."""
        if given_betas is not None:
            betas = np.asarray(given_betas, dtype=np.float64)
        else:
            betas = make_beta_schedule(beta_schedule, timesteps, linear_start,
                                       linear_end, cosine_s)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = (1 - v_posterior) * betas * (
            1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod) + v_posterior * betas
        if parameterization == "eps":
            with np.errstate(divide="ignore"):
                lvlb_weights = betas**2 / (
                    2 * posterior_variance * alphas * (1 - alphas_cumprod))
        elif parameterization == "x0":
            lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * (1 - alphas_cumprod))
        elif parameterization == "v":
            lvlb_weights = np.ones_like(betas)
        else:
            raise ValueError(f"unknown parameterization {parameterization}")
        if len(lvlb_weights) > 1:
            lvlb_weights[0] = lvlb_weights[1]
        if timestep_map is None:
            timestep_map = np.arange(len(betas))
        values = dict(
            betas=betas,
            alphas_cumprod=alphas_cumprod,
            alphas_cumprod_prev=alphas_cumprod_prev,
            sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
            log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
            posterior_variance=posterior_variance,
            posterior_log_variance_clipped=np.log(np.maximum(posterior_variance, 1e-20)),
            posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
            posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
            / (1.0 - alphas_cumprod),
            lvlb_weights=lvlb_weights,
        )
        tensors = {k: torch.tensor(np.asarray(v, np.float32), device=device)
                   for k, v in values.items()}
        tensors["timestep_map"] = torch.tensor(
            np.asarray(timestep_map, np.int64), device=device)
        return cls(**tensors)


def respace_schedule(base: DiffusionSchedule, num_steps: int | str) -> DiffusionSchedule:
    """Keep the :func:`space_timesteps` subset and recompute betas so the
    cumulative alpha product over the kept steps is preserved. Reads the
    base's float32 ``alphas_cumprod``, as the JAX package does."""
    alphas_cumprod = base.alphas_cumprod.cpu().numpy().astype(np.float64)
    n = int(alphas_cumprod.shape[0])
    counts = [num_steps] if isinstance(num_steps, int) else num_steps
    use_timesteps = space_timesteps(n, counts)
    last = 1.0
    new_betas = []
    for i in use_timesteps:
        new_betas.append(1 - alphas_cumprod[i] / last)
        last = alphas_cumprod[i]
    return DiffusionSchedule.create(given_betas=np.array(new_betas),
                                    timestep_map=use_timesteps,
                                    device=base.betas.device)


def extract(coefs: torch.Tensor, t: torch.Tensor | int, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients, shaped to broadcast over an
    ``ndim``-dimensional batch tensor."""
    out = coefs[t]
    return out.reshape(tuple(out.shape) + (1,) * (ndim - out.ndim))


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor, t, noise: torch.Tensor):
    """sqrt(ac_t) x0 + sqrt(1-ac_t) eps."""
    return (extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)


def predict_start_from_noise(sched: DiffusionSchedule, x_t: torch.Tensor, t,
                             noise: torch.Tensor) -> torch.Tensor:
    return (extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)


def predict_start_from_z_and_v(sched: DiffusionSchedule, x_t: torch.Tensor, t,
                               v: torch.Tensor) -> torch.Tensor:
    """x_0 from x_t and the v-prediction."""
    return (extract(sched.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(sched.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v)


def get_v(sched: DiffusionSchedule, x: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
    """The v-prediction target of x_0 = ``x`` noised by ``noise`` at t."""
    return (extract(sched.sqrt_alphas_cumprod, t, x.ndim) * noise
            - extract(sched.sqrt_one_minus_alphas_cumprod, t, x.ndim) * x)


def q_posterior(sched: DiffusionSchedule, x_start: torch.Tensor, x_t: torch.Tensor, t):
    """Posterior q(x_{t-1} | x_t, x_0): (mean, variance, log_variance)."""
    mean = (extract(sched.posterior_mean_coef1, t, x_t.ndim) * x_start
            + extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t)
    var = extract(sched.posterior_variance, t, x_t.ndim)
    log_var = extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, var, log_var


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings, [N] -> [N, dim] (cos | sin halves), float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb

"""Window-parallel guided sampling with a halo exchange between ranks.

Counterpart of ``mgldvsr_tpu/parallel/sharded_sampler.py``. The reference
restores its 5-frame windows independently, one per GPU (scripts
old.py:294-296). Here consecutive windows run one per rank and, at every
sampling step, each rank sends its window's first frame latent to the rank
on its left (one ``[1, h, w, c]`` tensor, 64 KB at 512px), so the motion
guidance also pulls each window's last frame towards the warped first frame
of the next window. The JAX package does the same with ``ppermute`` inside
``shard_map``; here each rank is its own process and the exchange is an
explicit ``batch_isend_irecv``.

The neighbour's frame is a constant in this rank's correction: the boundary
term's gradient is taken with respect to this rank's last frame alone
(:func:`boundary_grad`), a warp on the card (``warp_forward``, kernel 1
alone) and a few elementwise operations.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from mgldvsr_tpu_torch.core.diffusion import SamplerConfig, p_sample
from mgldvsr_tpu_torch.core.schedules import DiffusionSchedule
from mgldvsr_tpu_torch.ops.kernels.flow_warp import warp_forward, warp_plain

# (this rank's first frame [1,h,w,c]) -> (the right neighbour's, has_right)
Exchange = Callable[[torch.Tensor], Tuple[torch.Tensor, int]]


def boundary_loss_plain(last: torch.Tensor, neighbor_first: torch.Tensor,
                        bflow: torch.Tensor, bocc: torch.Tensor) -> torch.Tensor:
    """mean |m·warp(neighbor_first, bflow) − m·last| with m = 1 − bocc:
    this window's last frame latent against the next window's first, warped
    back across the boundary. last, neighbor_first [1,h,w,c]; bflow
    [1,h,w,2]; bocc [1,h,w,1], 1 = occluded."""
    warped = warp_plain(neighbor_first, bflow)
    m = 1.0 - bocc
    return torch.mean(torch.abs(m * warped - m * last))


def boundary_grad(last: torch.Tensor, neighbor_first: torch.Tensor, bflow: torch.Tensor,
                  bocc: torch.Tensor) -> torch.Tensor:
    """d :func:`boundary_loss_plain` / d last, the neighbour's frame held
    constant: −m·sign(m·warped − m·last) / (h·w·c). On the card the warp is
    the ``warp_forward`` kernel, which takes a contiguous float32
    ``neighbor_first`` and ``bflow``; on the CPU the plain warp."""
    warped = warp_forward(neighbor_first, bflow)
    m = 1.0 - bocc
    return -(torch.sign(m * warped - m * last) / last.numel()) * m


def exchange_first(first: torch.Tensor, group=None) -> Tuple[torch.Tensor, int]:
    """The halo, right to left: send this rank's first frame latent
    ``first`` ([1,h,w,c], contiguous) to rank r−1 and receive rank r+1's into
    a new buffer, in one ``batch_isend_irecv``. Returns (the right
    neighbour's first frame, has_right); the last rank receives nothing and
    gets zeros and 0, as ``ppermute`` leaves a rank without a source."""
    r, n = dist.get_rank(group), dist.get_world_size(group)
    neighbor = torch.zeros_like(first)
    ops = []
    if r > 0:
        ops.append(dist.P2POp(dist.isend, first, group=group, group_peer=r - 1))
    if r < n - 1:
        ops.append(dist.P2POp(dist.irecv, neighbor, group=group, group_peer=r + 1))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return neighbor, int(r < n - 1)


def sharded_step(sched: DiffusionSchedule, denoise_fn: Callable, x: torch.Tensor, i: int,
                 generator: Optional[torch.Generator], cfg: SamplerConfig, flows, masks,
                 bflow: torch.Tensor, bocc: torch.Tensor, exchange: Exchange,
                 boundary_weight: float = 1.0) -> torch.Tensor:
    """One guided step of this rank's window ``x`` [t,h,w,c], in the JAX
    package's order: the posterior, the noise, the latents, the exchange of
    first frames (``exchange``, e.g. :func:`exchange_first` on a group), then
    ``grad = guidance_grad + boundary_weight · has_right · boundary_grad``
    and ``latents −= guidance_scale · log_var · grad``. Where the boundary
    term is multiplied by 0 it is not computed."""
    t = cfg.num_frames

    def boundary(latents):
        neighbor, has_right = exchange(latents[:1].contiguous())
        if not (has_right and boundary_weight):
            return None
        g = torch.zeros_like(latents)
        g[t - 1:] = boundary_weight * boundary_grad(latents[t - 1:], neighbor, bflow, bocc)
        return g

    return p_sample(sched, denoise_fn, x, i, generator, cfg, flows, masks, extra_grad=boundary)


def rank_generator(generator: torch.Generator, group=None) -> torch.Generator:
    """A generator of this rank's own: one seed drawn from ``generator``
    (the same on every rank when every rank holds it in the same state) with
    the rank folded in, as the JAX package folds the shard index into its
    key."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
    mixed = (seed ^ (dist.get_rank(group) * 0x9E3779B97F4A7C15)) % 2 ** 63
    return torch.Generator(device=generator.device).manual_seed(mixed)


def sample_video_sharded(sched: DiffusionSchedule, denoise_fn: Callable, x_T: torch.Tensor,
                         generator: Optional[torch.Generator], cfg: SamplerConfig, flows,
                         masks, bflow: torch.Tensor, bocc: torch.Tensor,
                         boundary_weight: float = 1.0, group=None) -> torch.Tensor:
    """The respaced guided reverse process of this rank's window, the rank
    r of ``group`` holding window r of consecutive windows, coupled to its
    right neighbour at every step.

    x_T [t,h,w,c]; flows / masks this window's ([1,t-1,h,w,2] /
    [1,t-1,h,w,1] pairs); bflow [1,h,w,2] warps window r+1's first frame
    towards window r's last, bocc [1,h,w,1] its occlusion (unused on the
    last rank). ``generator`` should be this rank's own
    (:func:`rank_generator`); at temperature 0 none is needed. Returns the
    final latents [t,h,w,c]."""
    x = x_T
    for i in range(sched.num_timesteps - 1, -1, -1):
        x = sharded_step(sched, denoise_fn, x, i, generator, cfg, flows, masks, bflow, bocc,
                         lambda first: exchange_first(first, group), boundary_weight)
    return x

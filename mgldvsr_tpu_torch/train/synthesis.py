"""Real-ESRGAN's two-stage synthesis degradation, on the device.

Counterpart of ``mgldvsr_tpu/train/synthesis.py``: USM-sharpened GT ->
blur (kernel1) -> a random rescale -> Gaussian or Poisson-like noise ->
JPEG -> blur (kernel2, with a probability) -> a random rescale -> noise ->
bicubic to GT/sf -> sinc -> JPEG -> uint8 levels, batched.

The rescales are the JAX package's static scale buckets (``K`` scales,
each a down-up resample back to the working size, chosen per batch). JAX
computes every branch under ``lax.switch`` / ``jnp.where``; here only the
chosen one runs (a Python ``if``), which gives the same value. Every random
decision is split from the arithmetic: :func:`draw_synthesis` makes them
from a ``torch.Generator`` and :func:`apply_synthesis` takes them, so a
test can hand it the JAX package's own draws. The JAX package draws the
down and the up bucket from one key (``synthesis.py:128-131``); here they
are two draws, and the choice among them is the same function of them.
Blur kernels are made on the host per clip (:func:`sample_degradation_kernels`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mgldvsr_tpu_torch.data.blur_kernels import circular_lowpass_kernel, make_kernel
from mgldvsr_tpu_torch.ops.diffjpeg import diff_jpeg
from mgldvsr_tpu_torch.ops.img_process import (NoiseDraw, add_gaussian_noise, add_poisson_noise,
                                               draw_noise, draw_uniform, filter2d, usm_sharp)
from mgldvsr_tpu_torch.ops.resize import resize2d

_METHODS = ("area", "bilinear", "bicubic")


@dataclasses.dataclass(frozen=True)
class SynthesisConfig:
    """The JAX package's fields and defaults (the mgldvsr degradation
    block)."""

    sf: int = 4
    resize_prob: Tuple[float, float, float] = (0.2, 0.7, 0.1)
    resize_range: Tuple[float, float] = (0.15, 1.5)
    gaussian_noise_prob: float = 0.5
    noise_range: Tuple[float, float] = (1, 30)
    poisson_scale_range: Tuple[float, float] = (0.05, 3.0)
    gray_noise_prob: float = 0.4
    jpeg_range: Tuple[float, float] = (30, 95)
    second_blur_prob: float = 0.8
    resize_prob2: Tuple[float, float, float] = (0.3, 0.4, 0.3)
    resize_range2: Tuple[float, float] = (0.3, 1.2)
    gaussian_noise_prob2: float = 0.5
    noise_range2: Tuple[float, float] = (1, 25)
    poisson_scale_range2: Tuple[float, float] = (0.05, 2.5)
    gray_noise_prob2: float = 0.4
    jpeg_range2: Tuple[float, float] = (30, 95)
    final_sinc_prob: float = 0.8
    n_scale_buckets: int = 7
    use_usm: bool = True


def sample_degradation_kernels(
    rng: np.random.RandomState,
    kernel_sizes=(7, 9, 11, 13, 15, 17, 19, 21),
    kernel_list=("iso", "aniso", "generalized_iso", "generalized_aniso",
                 "plateau_iso", "plateau_aniso", "sinc"),
    kernel_prob=(0.405, 0.225, 0.108, 0.027, 0.108, 0.027, 0.1),
    sinc_prob: float = 0.1,
    pad_to: int = 21,
) -> Dict[str, np.ndarray]:
    """A clip's kernels on the host: ``kernel1``, ``kernel2`` and
    ``sinc_kernel``, each padded to ``pad_to`` x ``pad_to``; the JAX
    package's draws from ``rng`` in its order."""

    def one(sigma_hi):
        ktype = rng.choice(kernel_list, p=kernel_prob)
        ksize = int(rng.choice(kernel_sizes))
        k = make_kernel(ktype, ksize,
                        sigma_x=rng.uniform(0.2, sigma_hi), sigma_y=rng.uniform(0.2, sigma_hi),
                        rotate_angle=rng.uniform(-np.pi, np.pi),
                        beta_gaussian=rng.uniform(0.5, 4), beta_plateau=rng.uniform(1, 2),
                        omega=rng.uniform(np.pi / 3, np.pi))
        pad = (pad_to - ksize) // 2
        return np.pad(k, ((pad, pad), (pad, pad)))

    if rng.uniform() < sinc_prob:
        ksize = int(rng.choice(kernel_sizes))
        omega = rng.uniform(np.pi / 3 if ksize < 13 else np.pi / 5, np.pi)
        sinc = circular_lowpass_kernel(omega, ksize, pad_to=pad_to)
    else:
        sinc = np.zeros((pad_to, pad_to), np.float32)
        sinc[pad_to // 2, pad_to // 2] = 1.0
    return {"kernel1": one(3.0).astype(np.float32), "kernel2": one(1.5).astype(np.float32),
            "sinc_kernel": sinc.astype(np.float32)}


class RescaleDraw(NamedTuple):
    """A rescale's draws: ``u`` in [0, 1) picks the mode (up below p_up,
    down below p_up + p_down, else keep); ``down_idx`` in [0, K//2) and
    ``up_idx`` in [K//2 + 1, K) the bucket; ``method`` in [0, 3) area,
    bilinear or bicubic."""
    u: float
    down_idx: int
    up_idx: int
    method: int


class StageDraw(NamedTuple):
    """One degradation stage's draws: its rescale, ``use_gaussian`` in
    [0, 1) (Gaussian noise below the stage's probability, else
    Poisson-like), that noise's draws (of the chosen kind) and the JPEG
    qualities [N]."""
    rescale: RescaleDraw
    use_gaussian: float
    noise: NoiseDraw
    quality: torch.Tensor


class SynthesisDraws(NamedTuple):
    """Every random decision of :func:`apply_synthesis`: the two stages'
    and ``blur2`` in [0, 1) (the second blur below its probability)."""
    stage1: StageDraw
    blur2: float
    stage2: StageDraw


def scale_buckets(lo: float, hi: float, n_buckets: int) -> np.ndarray:
    """K scales: K // 2 down buckets up to 0.999, 1, and the up buckets
    from 1.001."""
    return np.concatenate([np.linspace(lo, 0.999, n_buckets // 2), [1.0],
                           np.linspace(1.001, hi, n_buckets - n_buckets // 2 - 1)])


def bucket_of(draw: RescaleDraw, prob: Tuple[float, float, float], n_buckets: int) -> int:
    """The bucket a rescale's draws choose."""
    p_up, p_down, _ = prob
    if draw.u < p_up:
        return int(draw.up_idx)
    if draw.u < p_up + p_down:
        return int(draw.down_idx)
    return n_buckets // 2


def bucketed_rescale(x: torch.Tensor, draw: RescaleDraw, prob, scale_range,
                     n_buckets: int) -> torch.Tensor:
    """[N,H,W,C] down and back up to H x W at the chosen bucket's scale,
    with the chosen method (the keep bucket: ``x`` as it is)."""
    h, w = x.shape[1:3]
    scale = float(scale_buckets(*scale_range, n_buckets)[bucket_of(draw, prob, n_buckets)])
    if scale == 1.0:
        return x
    method = _METHODS[int(draw.method)]
    size = (max(int(h * scale), 1), max(int(w * scale), 1))
    return resize2d(resize2d(x, size, method=method), (h, w), method=method)


def _draw_stage(generator, n, h, w, n_buckets, gaussian_prob, noise_range, poisson_range,
                gray_prob, jpeg_range, device) -> StageDraw:
    def scalar():
        return float(torch.rand((), generator=generator, device=device))

    def randint(lo, hi):
        return int(torch.randint(lo, hi, (), generator=generator, device=device))

    rescale = RescaleDraw(scalar(), randint(0, n_buckets // 2),
                          randint(n_buckets // 2 + 1, n_buckets), randint(0, 3))
    use_gaussian = scalar()
    gaussian = use_gaussian < gaussian_prob
    noise = draw_noise(generator, (n, h, w, 3), noise_range if gaussian else poisson_range,
                       gray_prob, device, gaussian=gaussian)
    return StageDraw(rescale, use_gaussian, noise,
                     draw_uniform(n, *jpeg_range, generator, device))


def draw_synthesis(generator: Optional[torch.Generator], n: int, h: int, w: int,
                   cfg: SynthesisConfig = SynthesisConfig(), device="cuda") -> SynthesisDraws:
    """The draws of :func:`apply_synthesis` for a GT batch [n,h,w,3], from
    ``generator`` (on ``device``). Only the chosen noise's field is drawn."""
    k = cfg.n_scale_buckets
    stage1 = _draw_stage(generator, n, h, w, k, cfg.gaussian_noise_prob, cfg.noise_range,
                         cfg.poisson_scale_range, cfg.gray_noise_prob, cfg.jpeg_range, device)
    blur2 = float(torch.rand((), generator=generator, device=device))
    stage2 = _draw_stage(generator, n, h, w, k, cfg.gaussian_noise_prob2, cfg.noise_range2,
                         cfg.poisson_scale_range2, cfg.gray_noise_prob2, cfg.jpeg_range2, device)
    return SynthesisDraws(stage1, blur2, stage2)


def _noise(stage: StageDraw, gaussian_prob: float) -> Callable[[torch.Tensor], torch.Tensor]:
    if stage.use_gaussian < gaussian_prob:
        return lambda x: add_gaussian_noise(x, stage.noise)
    return lambda x: add_poisson_noise(x, stage.noise)


def _jpeg(quality: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda x: diff_jpeg(torch.clamp(x, 0, 1), quality)


def synthesis_steps(kernels: Dict[str, torch.Tensor], draws: SynthesisDraws, h: int, w: int,
                    cfg: SynthesisConfig = SynthesisConfig()
                    ) -> List[Tuple[str, Callable[[torch.Tensor], torch.Tensor]]]:
    """The chain after the sharpening, as (name, function) steps on
    [N,h,w,3] images (any device: each step moves what it takes to its
    input's): the chosen branch of each decision only. A JPEG step's name
    starts with ``jpeg``."""
    s1, s2 = draws.stage1, draws.stage2
    steps = [("blur1", lambda x: filter2d(x, kernels["kernel1"])),
             ("rescale1", lambda x: bucketed_rescale(x, s1.rescale, cfg.resize_prob,
                                                     cfg.resize_range, cfg.n_scale_buckets)),
             ("noise1", _noise(s1, cfg.gaussian_noise_prob)),
             ("jpeg1", _jpeg(s1.quality))]
    if draws.blur2 < cfg.second_blur_prob:
        steps.append(("blur2", lambda x: filter2d(x, kernels["kernel2"])))
    steps += [("rescale2", lambda x: bucketed_rescale(x, s2.rescale, cfg.resize_prob2,
                                                      cfg.resize_range2, cfg.n_scale_buckets)),
              ("noise2", _noise(s2, cfg.gaussian_noise_prob2)),
              # the final resize to GT/sf, sinc and JPEG (the reference's order is
              # random; the JAX package applies its majority branch, as here)
              ("resize", lambda x: resize2d(x, (h // cfg.sf, w // cfg.sf), method="bicubic")),
              ("sinc", lambda x: filter2d(x, kernels["sinc_kernel"])),
              ("jpeg2", _jpeg(s2.quality)),
              ("levels", lambda x: torch.round(torch.clamp(x, 0, 1) * 255.0) / 255.0)]
    return steps


def apply_synthesis(gt_01: torch.Tensor, kernels: Dict[str, torch.Tensor],
                    draws: SynthesisDraws, cfg: SynthesisConfig = SynthesisConfig()
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gt_01 [N,H,W,3] in [0, 1] (H, W multiples of 16·sf), the kernels
    ([k,k] or a kernel a sample [N,k,k], numpy or tensors) and the draws ->
    (lq [N,H/sf,W/sf,3] on the 1/255 grid, the sharpened GT)."""
    n, h, w, _ = gt_01.shape
    kern = {k: torch.as_tensor(v).to(gt_01.device) for k, v in kernels.items()}
    gt = usm_sharp(gt_01) if cfg.use_usm else gt_01
    out = gt
    for _, step in synthesis_steps(kern, draws, h, w, cfg):
        out = step(out)
    return out, gt


def synthesize_lq(generator: Optional[torch.Generator], gt_01: torch.Tensor,
                  kernels: Dict[str, torch.Tensor], cfg: SynthesisConfig = SynthesisConfig()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`draw_synthesis` from ``generator`` on ``gt_01``'s device,
    then :func:`apply_synthesis`."""
    n, h, w, _ = gt_01.shape
    return apply_synthesis(gt_01, kernels, draw_synthesis(generator, n, h, w, cfg,
                                                          gt_01.device), cfg)

"""Seeded random weights, made on the module's own device.

The counterpart of the JAX pipeline's fast random init
(``mgldvsr_tpu/infer/pipeline._synthesize_leaves``): biases, temporal
alphas and running means are zeros; norm scales and running variances are
ones; every other weight is a normal with std 1/sqrt(fan_in), including
the output convs that upstream zero-initialises, so the UNet's output is
not zero. The numbers come from one ``torch.Generator`` and differ from the
JAX package's draws; only their statistics agree.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from mgldvsr_tpu_torch.flow.raft import FrozenBatchNorm
from mgldvsr_tpu_torch.models.discriminator import FlaxBatchNorm
from mgldvsr_tpu_torch.models.layers import GroupNorm
from mgldvsr_tpu_torch.models.vae import is_temporal_or_fusion

_NORMS = (GroupNorm, nn.LayerNorm, FrozenBatchNorm, FlaxBatchNorm)
_EMBEDDINGS = ("token_embedding.weight", "positional_embedding")


@torch.no_grad()
def init_module_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of ``module`` in place."""
    for mod_name, mod in module.named_modules():
        tensors = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for name, t in tensors:
            full = f"{mod_name}.{name}" if mod_name else name
            if name in ("bias", "running_mean", "temporal_alpha", "in_proj_bias"):
                t.zero_()
            elif isinstance(mod, _NORMS) or name == "running_var":
                t.fill_(1.0)
            elif t.ndim < 2:
                t.normal_(0.0, 0.02, generator=generator)
            else:
                fan_in = t.shape[0] if full.endswith(_EMBEDDINGS) else math.prod(t.shape[1:])
                t.normal_(0.0, 1.0 / math.sqrt(max(fan_in, 1)), generator=generator)
    return module


def init_pipeline_weights(pipe, seed: int) -> None:
    """Seeded weights for every tower of a pipeline, on its device."""
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    for tower in pipe.towers().values():
        init_module_weights(tower, gen)


@torch.no_grad()
def jitter_weights(pipe, scale: float, seed: int) -> None:
    """Add ``scale`` x N(0, 1) to every UNet and struct-cond parameter (the
    JAX trainer tests' jitter), then to the VAE decoder's temporal and
    fusion layers. Seeded weights leave the temporal blend scalars and every
    bias at zero, so the temporal convs would get no gradient; a
    checkpoint's weights never are. The UNet's and struct-cond's draws come
    first, so they do not depend on the VAE's widths."""
    gen = torch.Generator(device=pipe.device).manual_seed(seed + 99)
    params = [p for tower in (pipe.unet, pipe.structcond) for p in tower.parameters()]
    params += [p for name, p in pipe.vae.named_parameters() if is_temporal_or_fusion(name)]
    for p in params:
        p.add_(scale * torch.randn(p.shape, generator=gen, device=p.device, dtype=p.dtype))

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
from mgldvsr_tpu_torch.models.layers import GroupNorm

_NORMS = (GroupNorm, nn.LayerNorm, FrozenBatchNorm)
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

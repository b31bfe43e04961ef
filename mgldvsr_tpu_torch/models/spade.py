"""SPADE: normalization modulated per pixel by struct-cond features.

Counterpart of ``mgldvsr_tpu/models/spade.py``. The struct-cond encoder
gives a dict of feature maps keyed by spatial width; each block takes the
one matching its own width.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from mgldvsr_tpu_torch.models.layers import GroupNorm, conv3x3


class SPADE(nn.Module):
    def __init__(self, norm_channels: int, label_channels: int, hidden: int = 128,
                 dtype=torch.float32):
        super().__init__()
        self.param_free_norm = GroupNorm(norm_channels, dtype=dtype)
        self.mlp_shared = nn.Sequential(conv3x3(label_channels, hidden), nn.ReLU())
        self.mlp_gamma = conv3x3(hidden, norm_channels)
        self.mlp_beta = conv3x3(hidden, norm_channels)

    def forward(self, x: torch.Tensor, segmap_dict: Dict[str, torch.Tensor]):
        segmap = segmap_dict[str(x.shape[-1])]
        normalized = self.param_free_norm(x)
        actv = self.mlp_shared(segmap)
        return normalized * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)

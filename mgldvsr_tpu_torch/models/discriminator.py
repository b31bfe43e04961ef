"""PatchGAN discriminator: taming's ``NLayerDiscriminator`` (ndf 64, 3
layers) of the stage-2 GAN loss.

Counterpart of ``mgldvsr_tpu/models/discriminator.py``: Conv(3->64, k4 s2)
and LeakyReLU 0.2; per layer Conv(k4, s2 then s1 for the last, no bias),
BatchNorm and LeakyReLU with the channels doubling (at most 8x); a final
Conv(->1, k4 s1). Keys are taming's sequential ``main.{i}``, the layout
``mgldvsr_tpu/io/ckpt_convert.convert_discriminator`` reads.

The BatchNorm has flax's semantics, not ``nn.BatchNorm2d``'s: training
normalises with the batch mean and the biased variance E[x^2] - E[x]^2
(clipped at 0), and moves the running statistics by
``r = 0.9 r + 0.1 batch`` with that same biased variance; evaluation
normalises with the running statistics; eps is 1e-5. Training mode is the
``train`` argument of each call, not ``module.train()``. It computes in its
weights' dtype (float32 as built). Over several ranks (``group``, each with
its share of the batch) a training pass normalises with the statistics of
the whole batch, as the JAX step over the batch of every rank's clip does:
the group sums the ranks' per-channel means of x and x², each weighted by
its share of the rows, with a gradient through the sum; the running
statistics then move the same on every rank. On a (data x tensor) grid the
group is the data group: the T ranks of a data index hold the same rows.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.parallel import mesh


class FlaxBatchNorm(nn.Module):
    """BatchNorm over [N, C, H, W] with flax ``nn.BatchNorm`` semantics
    (momentum 0.9 on the old value, eps 1e-5, biased running variance)."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool, group=None) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        if train:
            mean = x.mean(dim=(0, 2, 3))
            mean_sq = (x * x).mean(dim=(0, 2, 3))
            if group is not None:
                # the whole batch's means: each rank's weighted by its share
                # of the group's values a channel (1.0 exactly in a world of one)
                count = torch.tensor(float(x.numel() // x.shape[1]), device=x.device)
                share = count / mesh.all_reduce_sum(count, group)
                both = mesh.all_reduce_sum(torch.stack([mean, mean_sq]) * share, group)
                mean, mean_sq = both.unbind()
            var = (mean_sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[None, :, None, None]) * mul[None, :, None, None]
        return y + self.bias[None, :, None, None]


class NLayerDiscriminator(nn.Module):
    """[N, 3, H, W] -> patch logits [N, 1, H/8 - 2, W/8 - 2] (at ndf 64,
    3 layers)."""

    def __init__(self, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        layers = [nn.Conv2d(3, ndf, 4, stride=2, padding=1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, stride=stride, padding=1,
                                 bias=False),
                       FlaxBatchNorm(ndf * mult), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * mult, 1, 4, stride=1, padding=1))
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, train: bool = False, group=None) -> torch.Tensor:
        """``group``: the ranks whose rows make the batch of a training
        pass (None: this process's rows alone)."""
        x = x.to(self.main[0].weight.dtype)
        for layer in self.main:
            if isinstance(layer, FlaxBatchNorm):
                x = layer(x, train, group)
            elif isinstance(layer, nn.LeakyReLU):
                x = F.leaky_relu(x, 0.2)
            else:
                x = layer(x)
        return x

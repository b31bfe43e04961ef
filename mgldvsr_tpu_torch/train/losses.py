"""The stage-2 loss terms: frame-difference L1, the Sobel-weighted
flow-warp consistency (swc), and the GAN pieces.

Counterpart of ``mgldvsr_tpu/train/losses.py`` (the reference's
``contperceptual.py``), with its NHWC signatures: frames are
[(b t), H, W, C]. ``swc_loss`` keeps the reference's loop quirks (a zeros
first term, the warp one iteration stale) and the JAX package's argument
order (see :func:`swc_loss`). The GAN weights are plain floats and 0-dim
tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from mgldvsr_tpu_torch.ops.kernels.flow_warp import warp_forward

# kornia's normalised Sobel kernels (sum |k| = 8)
_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def sobel_magnitude(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-channel Sobel gradient magnitude with replicate padding
    (``kornia.filters.sobel``), computed in x's dtype. x [N,H,W,C]."""
    c = x.shape[-1]
    kx = torch.tensor(_SOBEL_X, dtype=x.dtype, device=x.device) / 8.0
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")

    def depthwise(k):
        return F.conv2d(xp, k[None, None].expand(c, 1, 3, 3), groups=c)

    gx, gy = depthwise(kx), depthwise(kx.T.contiguous())
    return torch.sqrt(gx * gx + gy * gy + eps).permute(0, 2, 3, 1)


def l1_diff(x: torch.Tensor, y: torch.Tensor, t: int) -> torch.Tensor:
    """|dx - dy| of the frame differences d(f)_i = f_i - f_{i+1} within each
    clip of ``t`` frames: [(b t),H,W,C] in, [(b (t-1)),H,W,C] out."""
    b = x.shape[0] // t
    xv = x.reshape(b, t, *x.shape[1:])
    yv = y.reshape(b, t, *y.shape[1:])
    d = (xv[:, :-1] - xv[:, 1:]) - (yv[:, :-1] - yv[:, 1:])
    return d.abs().reshape(b * (t - 1), *x.shape[1:])


def warp_frames(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The swc loss's warp, zeros outside: kernel 1 (``warp_forward``) on
    a CUDA tensor, its plain version on a CPU one. Float32, no gradient."""
    return warp_forward(x.float().contiguous(), flow.float().contiguous())


def swc_loss(hr: torch.Tensor, gt: torch.Tensor, t: int,
             flows: Tuple[torch.Tensor, torch.Tensor],
             occs: Tuple[torch.Tensor, torch.Tensor], w: float = 3.0) -> torch.Tensor:
    """Sobel-weighted, occlusion-masked warp consistency of ``hr``'s frames.

    ``flows`` and ``occs`` are the (forward, backward) stacks [b, t-1, H, W,
    2 | 1] of the frozen flownet on the GT frames. The weight is
    ``1 + w * sobel(gt)``, without gradient. The stage-2 generator calls
    ``swc_loss(gt, recon, ...)``, as the JAX package does: the warped
    frames are the GT's, and the reconstruction enters only through the
    weight, so the term has a value and no gradient (whether upstream
    means this is an open question). ``hr`` must carry no gradient on the
    card, where the warp is a kernel without one."""
    fwd_flows, bwd_flows = flows
    fwd_occs, bwd_occs = occs
    b = hr.shape[0] // t
    weight = 1.0 + w * sobel_magnitude(gt).detach()
    hrv = hr.reshape(b, t, *hr.shape[1:])
    wv = weight.reshape(b, t, *weight.shape[1:])

    def l1(a, y):
        return (a - y).abs().mean()

    loss = torch.zeros((), dtype=torch.float32, device=hr.device)
    prev = torch.zeros_like(hrv[:, 0])
    for i in range(t - 2, -1, -1):
        m = wv[:, i] * (1.0 - fwd_occs[:, i])
        loss = loss + l1(m * prev, m * hrv[:, i])
        prev = warp_frames(hrv[:, i], fwd_flows[:, i])
    prev = torch.zeros_like(hrv[:, 0])
    for i in range(1, t):
        m = wv[:, i] * (1.0 - bwd_occs[:, i - 1])
        loss = loss + l1(m * prev, m * hrv[:, i])
        prev = warp_frames(hrv[:, i], bwd_flows[:, i - 1])
    return loss


# ---------------------------------------------------------------------------
# GAN pieces
# ---------------------------------------------------------------------------


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """``value`` before ``threshold`` steps, ``weight`` from then on."""
    return value if global_step < threshold else weight


def adaptive_d_weight(nll_grad_norm: torch.Tensor, g_grad_norm: torch.Tensor,
                      disc_weight: float) -> torch.Tensor:
    """d_weight = ||dnll/dw_last|| / (||dg/dw_last|| + 1e-4), clipped to
    [0, 1e4], detached, times ``disc_weight``."""
    d = nll_grad_norm / (g_grad_norm + 1e-4)
    return d.clamp(0.0, 1e4).detach() * disc_weight

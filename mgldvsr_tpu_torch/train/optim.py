"""The training optimisers as plain functions on tensors.

The JAX trainers' optax chains, operation for operation in float32:
``MultiSteps(grad_accum)`` around ``clip_by_global_norm(max_grad_norm)``
(when set) and ``adamw`` (stage 1, ``mgldvsr_tpu/train/trainer.py:125-132``)
or ``adam(b1=0.5, b2=0.9)``, which is ``adamw`` with weight decay 0 (stage 2,
``mgldvsr_tpu/train/stage2.py:98-110``, generator and discriminator). The
defaults are optax ``adamw``'s, not ``torch.optim.AdamW``'s: b1 0.9, b2
0.999, weight decay 1e-4, eps 1e-8 added outside the square root, eps_root
0. ``mu_dtype="bfloat16"``
keeps the first moment in bf16 (the update reads it before it is stored,
and decays it by b1 rounded to bf16, as optax does); the second moment
stays float32. XLA contracts some of these products and sums into fused
multiply-adds, so the two agree to about one float32 ulp, not bit for bit.

``MultiSteps`` keeps the running mean of the micro-step gradients
(``acc + (g - acc) / (n + 1)``) and applies the inner update on every
``grad_accum``-th call; Adam's count, which drives its bias correction,
advances only then. The state is a dict of tensors keyed like the
parameters, so it saves with ``torch.save``.

Over several ranks (``step(..., zero=)``, a
:class:`~mgldvsr_tpu_torch.parallel.mesh.ZeroShard`) the same arithmetic
runs on each rank's slice of the tensors ZeRO-1 splits: the gradient, the
accumulator and both moments are slices, each rank updates its slice of a
master and the full masters are gathered; the clipping norm is the whole
gradient's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

Tensors = Dict[str, torch.Tensor]

# optax's, which both JAX trainers keep
EPS = 1e-8
EPS_ROOT = 0.0


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 5.0e-5
    mu_dtype: Optional[torch.dtype] = None
    max_grad_norm: Optional[float] = None
    grad_accum: int = 1
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 1e-4


def init_opt_state(params: Tensors, cfg: AdamWConfig) -> dict:
    """Zero moments (and accumulator when ``grad_accum > 1``) like
    ``params``; counts at 0."""
    def zeros(dtype=None):
        return {k: torch.zeros_like(p, dtype=dtype or p.dtype) for k, p in params.items()}

    return {"count": 0, "mini_step": 0, "gradient_step": 0, "mu": zeros(cfg.mu_dtype),
            "nu": zeros(), "acc": zeros() if cfg.grad_accum > 1 else None}


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum over tensors of their sums of squares (float32)."""
    total = None
    for t in tensors.values():
        s = (t * t).sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tensors, max_norm: float,
                        norm_fn: Callable[[Tensors], torch.Tensor] = global_norm) -> Tensors:
    """optax ``clip_by_global_norm``: unchanged below ``max_norm``, else
    each ``(g / norm) * max_norm``, the norm ``norm_fn(grads)``."""
    norm = norm_fn(grads)
    if bool(norm < max_norm):
        return grads
    return {k: (g / norm.to(g.dtype)) * max_norm for k, g in grads.items()}


def _bias_correction(decay: float, count: int, device) -> torch.Tensor:
    d = torch.tensor(decay, dtype=torch.float32, device=device)
    return 1 - d ** torch.tensor(float(count), dtype=torch.float32, device=device)


def adamw_updates(grads: Tensors, state: dict, params: Tensors, cfg: AdamWConfig,
                  norm_fn: Callable[[Tensors], torch.Tensor] = global_norm) -> Tensors:
    """optax ``[clip_by_global_norm] -> adamw`` on ``grads``: returns the
    updates (to add to ``params``) and advances ``state``'s count and
    moments in place."""
    if cfg.max_grad_norm:
        grads = clip_by_global_norm(grads, cfg.max_grad_norm, norm_fn)
    count = state["count"] + 1
    updates = {}
    for k, g in grads.items():
        mu_old, nu_old = state["mu"][k], state["nu"][k]
        # optax: (1 - b1) * g + b1 * mu with b1 in mu's dtype (bf16's 0.8984375
        # for a bf16 mu) and, as XLA computes it, the product not rounded
        b1 = torch.tensor(cfg.b1, dtype=mu_old.dtype).item()
        mu = (1 - cfg.b1) * g + b1 * mu_old.float()
        nu = (1 - cfg.b2) * (g * g) + cfg.b2 * nu_old
        bc1 = _bias_correction(cfg.b1, count, g.device)
        bc2 = _bias_correction(cfg.b2, count, g.device)
        mu_hat = mu / bc1.to(mu.dtype)
        nu_hat = nu / bc2.to(nu.dtype)
        u = mu_hat / (torch.sqrt(nu_hat + EPS_ROOT) + EPS)
        u = u + cfg.weight_decay * params[k]
        updates[k] = -cfg.learning_rate * u
        mu_old.copy_(mu)  # cast to mu_dtype on the way in
        nu_old.copy_(nu)
    state["count"] = count
    return updates


def step(grads: Tensors, state: dict, params: Tensors, cfg: AdamWConfig, zero=None) -> bool:
    """One micro-step of ``MultiSteps(grad_accum)`` around the inner chain:
    folds ``grads`` into the running mean and, on the ``grad_accum``-th
    micro-step, applies the inner update to ``params`` in place and zeroes
    the mean. Returns whether ``params`` changed. Without accumulation every
    call applies ``grads``.

    With ``zero`` (a ``ZeroShard``), ``grads`` is the group's reduced
    gradient (``zero.reduce_gradients``) and ``state`` this rank's (split
    tensors as slices): the update runs on this rank's slices of ``params``,
    then ``zero.all_gather`` fills in the other ranks' slices."""
    full = params
    norm_fn = global_norm
    if zero is not None:
        params = zero.locals(full)
        norm_fn = lambda g: zero.norm(g, global_norm)  # noqa: E731
    if cfg.grad_accum <= 1:
        updates = adamw_updates(grads, state, params, cfg, norm_fn)
        _apply(params, updates)
        state["gradient_step"] += 1
        if zero is not None:
            zero.all_gather(full)
        return True
    n = state["mini_step"]
    acc = state["acc"]
    for k, g in grads.items():
        a = acc[k]
        a.copy_(a + (g - a) / float(n + 1))
    emit = n == cfg.grad_accum - 1
    if emit:
        updates = adamw_updates(acc, state, params, cfg, norm_fn)
        _apply(params, updates)
        for a in acc.values():
            a.zero_()
        state["gradient_step"] += 1
        if zero is not None:
            zero.all_gather(full)
    state["mini_step"] = (n + 1) % cfg.grad_accum
    return emit


def _apply(params: Tensors, updates: Tensors) -> None:
    """optax ``apply_updates``: p + u in p's dtype."""
    for k, u in updates.items():
        p = params[k]
        p.copy_((p + u).to(p.dtype))

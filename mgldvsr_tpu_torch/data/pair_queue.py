"""The training-pair pool.

Counterpart of ``mgldvsr_tpu/data/pair_queue.py`` (the reference's
``_dequeue_and_enqueue``): a fixed pool of (lq, gt) pairs that each new
batch is pushed into and an equally large shuffled batch is popped from,
so that a step's samples do not share one batch's degradation draws. The
pool holds tensors on the caller's device, as the reference's does on the
GPU; the permutations are ``np.random.RandomState(seed).permutation``, the
JAX package's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class TrainingPairQueue:
    def __init__(self, queue_size: int = 180, seed: int = 0):
        self.queue_size = queue_size
        self._rng = np.random.RandomState(seed)
        self._lq: Optional[torch.Tensor] = None
        self._gt: Optional[torch.Tensor] = None
        self._ptr = 0

    def __call__(self, lq: torch.Tensor, gt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Push a batch; pop an equally large shuffled one (during the
        warm-up, while the pool fills, the batch itself)."""
        b = lq.shape[0]
        if self._lq is None:
            if self.queue_size % b:
                raise ValueError(f"queue size {self.queue_size} is not a multiple of the "
                                 f"batch size {b}")
            self._lq = lq.new_zeros((self.queue_size, *lq.shape[1:]))
            self._gt = gt.new_zeros((self.queue_size, *gt.shape[1:]))
        if self._ptr == self.queue_size:
            idx = torch.from_numpy(self._rng.permutation(self.queue_size)).to(lq.device)
            self._lq, self._gt = self._lq[idx], self._gt[idx]
            out = self._lq[:b].clone(), self._gt[:b].clone()
            self._lq[:b] = lq
            self._gt[:b] = gt
            return out
        self._lq[self._ptr:self._ptr + b] = lq
        self._gt[self._ptr:self._ptr + b] = gt
        self._ptr += b
        return lq, gt

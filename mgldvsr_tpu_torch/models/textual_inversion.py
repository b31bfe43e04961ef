"""Textual inversion: learned placeholder rows in the token embedding.

Counterpart of ``mgldvsr_tpu/models/textual_inversion.py`` (the reference's
``EmbeddingManager``): each placeholder token's row of the token
embedding's output is replaced by its learned row before the text
transformer runs (:func:`apply_single_vector`, ``torch.where``,
differentiable in the learned rows); the multi-vector form grows each
occurrence of a placeholder to N consecutive learned rows and truncates the
sequence back to its length (:func:`expand_multi_vector`, host numpy, where
the reference runs it); and the coarse-init loss pulls the rows towards
their initialiser words. The result plugs into
``OpenCLIPTextEncoder(tokens, embedded=...)``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

PROGRESSIVE_SCALE = 2000  # the reference's embedding_manager.py:10


def init_placeholder_params(placeholder_tokens: Mapping[str, int], token_dim: int,
                            num_vectors_per_token: int = 1,
                            init_embeddings: Optional[Mapping[str, np.ndarray]] = None,
                            seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """One learned [num_vectors, token_dim] float32 block a placeholder: an
    initialiser word's embedding repeated where given, else uniform [0, 1)
    from ``np.random.default_rng(seed)`` (the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in placeholder_tokens:
        if init_embeddings and name in init_embeddings:
            row = np.asarray(init_embeddings[name], np.float32).reshape(1, -1)
            block = np.repeat(row, num_vectors_per_token, 0)
        else:
            block = rng.random((num_vectors_per_token, token_dim), np.float32)
        out[name] = torch.from_numpy(block).to(device)
    return out


def apply_single_vector(params: Mapping[str, torch.Tensor], placeholder_tokens: Mapping[str, int],
                        tokens: torch.Tensor, embedded: torch.Tensor) -> torch.Tensor:
    """``embedded`` [B, L, D] with each placeholder token's row replaced by
    its learned row (the first of its block)."""
    for name, tok in placeholder_tokens.items():
        row = params[name][0].to(embedded.dtype)
        embedded = torch.where((tokens == tok)[..., None], row[None, None, :], embedded)
    return embedded


def expand_multi_vector(params: Mapping[str, torch.Tensor], placeholder_tokens: Mapping[str, int],
                        tokens: np.ndarray, embedded: np.ndarray,
                        progressive_counter: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Every occurrence of a placeholder becomes its ``num_vectors``
    learned rows (right to left, so that earlier columns stay put), each
    row then truncated to its length; with ``progressive_counter``
    (progressive words) 1 + counter // 2000 vectors at most. Host numpy:
    the new (tokens, embedded)."""
    tokens = np.array(tokens)
    embedded = np.array(embedded)
    n = tokens.shape[1]
    for name, tok in placeholder_tokens.items():
        block = np.asarray(torch.as_tensor(params[name]).detach().cpu(), embedded.dtype)
        n_vec = block.shape[0]
        if progressive_counter is not None:
            n_vec = min(n_vec, 1 + progressive_counter // PROGRESSIVE_SCALE)
        rows, cols = np.where(tokens == tok)
        order = np.argsort(-cols)
        for r, c in zip(rows[order], cols[order]):
            tokens[r] = np.concatenate([tokens[r][:c], np.full((n_vec,), tok, tokens.dtype),
                                        tokens[r][c + 1:]])[:n]
            embedded[r] = np.concatenate([embedded[r][:c], block[:n_vec],
                                          embedded[r][c + 1:]])[:n]
    return tokens, embedded


def embedding_norms_squared(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Each learned row's squared L2 norm, over the placeholders in name
    order."""
    allp = torch.cat([params[k] for k in sorted(params)], dim=0)
    return (allp * allp).sum(dim=-1)


def coarse_init_loss(params: Mapping[str, torch.Tensor],
                     initial: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The pull of the learned rows towards their initialiser words'
    embeddings."""
    loss = torch.zeros(())
    for key in initial:
        d = params[key] - torch.as_tensor(initial[key]).to(params[key])
        loss = loss + (d @ d.T).sum() / len(initial)
    return loss

"""The alternate conditioning encoders.

Counterpart of ``mgldvsr_tpu/models/encoders.py`` (the reference's
``ldm/modules/encoders/modules.py`` alternates; the default text tower is
:mod:`mgldvsr_tpu_torch.models.cliptext`):

- :class:`ClassEmbedder`: class ids [B] -> one cross-attention token [B,1,D].
- :class:`TransformerTextEmbedder`: token and learned position embeddings,
  ``depth`` bidirectional pre-LN blocks, a final LayerNorm (the reference's
  ``TransformerEmbedder`` / ``BERTEmbedder``, embeddings returned).
- :class:`SpatialRescaler`: repeated resizes and an optional 1x1 channel map.
- :class:`CLIPImageEncoder` and :class:`FrozenClipImageEmbedder`: the CLIP
  ViT image tower (patch conv, class token, ln_pre, blocks, ln_post,
  projection) with OpenAI ``clip.visual``'s key names, and
  :func:`clip_preprocess`.

Images are NHWC at the boundary, as in JAX. The blocks are the text
tower's :class:`~mgldvsr_tpu_torch.models.cliptext.ResidualAttentionBlock`;
at the ViT's 257 tokens no attention passes the kernel's gate, so they run
the plain attention. Resizes are ``jax.image.resize``'s
(:func:`mgldvsr_tpu_torch.ops.resize.image_resize`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from mgldvsr_tpu_torch.models.cliptext import ResidualAttentionBlock
from mgldvsr_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from mgldvsr_tpu_torch.ops.resize import image_resize

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class ClassEmbedder(nn.Module):
    """Class ids [B] -> [B, 1, embed_dim] (key ``embedding.weight``)."""

    def __init__(self, embed_dim: int, n_classes: int = 1000):
        super().__init__()
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, class_ids: torch.Tensor) -> torch.Tensor:
        return self.embedding(class_ids)[:, None, :]


@dataclasses.dataclass(frozen=True)
class TransformerTextConfig:
    vocab_size: int = 30522  # BERT's vocabulary (BERTEmbedder's default)
    width: int = 1280
    depth: int = 32
    heads: int = 8
    max_seq_len: int = 77
    dtype: torch.dtype = torch.float32


class _Blocks(nn.Module):
    def __init__(self, width: int, heads: int, act: str, depth: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, act) for _ in range(depth)])


class TransformerTextEmbedder(nn.Module):
    """tokens [B, L] -> embeddings [B, L, width] float32: no causal mask,
    learned absolute positions, pre-LN blocks, a final LayerNorm. Keys:
    ``token_emb.weight``, ``pos_emb.emb.weight``,
    ``attn_layers.resblocks.{i}.*`` and ``norm.*``."""

    def __init__(self, cfg: TransformerTextConfig = TransformerTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_emb = nn.Embedding(cfg.vocab_size, cfg.width)
        self.pos_emb = nn.Module()
        self.pos_emb.emb = nn.Embedding(cfg.max_seq_len, cfg.width)
        self.attn_layers = _Blocks(cfg.width, cfg.heads, "gelu", cfg.depth)
        self.norm = LayerNorm(cfg.width, eps=1e-5)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        pos = self.pos_emb.emb.weight[: tokens.shape[1]]
        x = (self.token_emb(tokens) + pos[None]).to(self.cfg.dtype)
        for block in self.attn_layers.resblocks:
            x = block(x, None)
        return self.norm(x).float()


class SpatialRescaler(nn.Module):
    """``n_stages`` resizes by ``multiplier`` (each side rounded, at least
    1) and, with ``out_channels``, a 1x1 conv (key ``channel_mapper``). NHWC."""

    def __init__(self, n_stages: int = 1, method: str = "bilinear", multiplier: float = 0.5,
                 in_channels: int = 3, out_channels: Optional[int] = None,
                 use_bias: bool = False):
        super().__init__()
        self.n_stages, self.method, self.multiplier = n_stages, method, multiplier
        self.channel_mapper = (Conv2d(in_channels, out_channels, 1, bias=use_bias)
                               if out_channels is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n_stages):
            h, w = x.shape[1:3]
            size = (max(int(round(h * self.multiplier)), 1),
                    max(int(round(w * self.multiplier)), 1))
            x = image_resize(x, size, method=self.method)
        if self.channel_mapper is not None:
            x = self.channel_mapper(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return x


@dataclasses.dataclass(frozen=True)
class CLIPImageConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    heads: int = 16
    layers: int = 24
    output_dim: Optional[int] = 768  # None: the pooled width, unprojected
    act: str = "quick_gelu"  # OpenAI's CLIP ViT towers
    dtype: torch.dtype = torch.float32


class CLIPImageEncoder(nn.Module):
    """CLIP-normalised images [B,H,W,3] -> the pooled embedding
    [B, output_dim] float32 (``pool=False``: every token [B, 1+N, width])."""

    def __init__(self, cfg: CLIPImageConfig = CLIPImageConfig()):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.width, cfg.patch_size
        self.conv1 = Conv2d(3, d, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.positional_embedding = nn.Parameter(
            torch.empty((cfg.image_size // p) ** 2 + 1, d))
        self.ln_pre = LayerNorm(d, eps=1e-5)
        self.transformer = _Blocks(d, cfg.heads, cfg.act, cfg.layers)
        self.ln_post = LayerNorm(d, eps=1e-5)
        self.proj = (nn.Parameter(torch.empty(d, cfg.output_dim))
                     if cfg.output_dim is not None else None)

    def forward(self, x: torch.Tensor, pool: bool = True) -> torch.Tensor:
        cfg = self.cfg
        h = self.conv1(x.permute(0, 3, 1, 2).to(cfg.dtype))
        h = h.flatten(2).transpose(1, 2)  # [B, N, D], patches row-major
        b, _, d = h.shape
        h = torch.cat([self.class_embedding.to(h.dtype).expand(b, 1, d), h], dim=1)
        h = self.ln_pre(h + self.positional_embedding[None].to(h.dtype)).to(cfg.dtype)
        for block in self.transformer.resblocks:
            h = block(h, None)
        if not pool:
            return h.float()
        h = self.ln_post(h[:, 0])
        if self.proj is not None:
            h = h @ self.proj.to(h.dtype)
        return h.float()


def clip_preprocess(images_pm1: torch.Tensor, size: int = 224,
                    resize: bool = True) -> torch.Tensor:
    """[-1, 1] NHWC images -> the tower's input: a bicubic resize to
    ``size`` without antialiasing (as kornia's in the reference), to [0, 1],
    then CLIP's mean and std."""
    x = images_pm1
    if resize and tuple(x.shape[1:3]) != (size, size):
        x = image_resize(x, (size, size), method="bicubic", antialias=False)
    x = (x + 1.0) / 2.0
    return (x - x.new_tensor(CLIP_IMAGE_MEAN)) / x.new_tensor(CLIP_IMAGE_STD)


class FrozenClipImageEmbedder(nn.Module):
    """[-1, 1] images -> the pooled CLIP image embedding; ``project_dim``
    adds a Linear (key ``linear``), as the reference's
    ``FrozenClipImageEmbedderNew``."""

    def __init__(self, cfg: CLIPImageConfig = CLIPImageConfig(),
                 project_dim: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.visual = CLIPImageEncoder(cfg)
        self.linear = (Linear(cfg.output_dim or cfg.width, project_dim)
                       if project_dim is not None else None)

    def forward(self, images_pm1: torch.Tensor) -> torch.Tensor:
        z = self.visual(clip_preprocess(images_pm1, self.cfg.image_size))
        return self.linear(z).float() if self.linear is not None else z

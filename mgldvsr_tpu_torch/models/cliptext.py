"""OpenCLIP text tower (the frozen conditioning encoder).

Counterpart of ``mgldvsr_tpu/models/cliptext.py``, with open_clip's
state-dict keys (``token_embedding``, ``positional_embedding``,
``transformer.resblocks.{i}``, ``ln_final``). With ``layer="penultimate"``
the tower holds and runs ``layers - 1`` blocks, then ``ln_final``, as the
JAX package does. At restore time the prompt is always empty, so
:func:`empty_prompt_tokens` gives its token row without a BPE vocabulary.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.models.layers import LayerNorm, Linear
from mgldvsr_tpu_torch.ops.attention import attention_math
from mgldvsr_tpu_torch.parallel.tensor import linear_columns

SOT_TOKEN = 49406
EOT_TOKEN = 49407


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 1024
    heads: int = 16
    layers: int = 24
    context_length: int = 77
    layer: str = "penultimate"  # or "last"
    act: str = "gelu"  # ViT-H-14: exact gelu; OpenAI CLIP: "quick_gelu"
    dtype: torch.dtype = torch.float32


def frozen_clip_vit_l_config(dtype: torch.dtype = torch.float32) -> CLIPTextConfig:
    """The SD 1.x text tower (upstream FrozenCLIPEmbedder, Hugging Face's
    CLIP ViT-L/14): width 768, 12 layers and heads, quick-gelu, the last
    layer's output after the final LayerNorm. Its checkpoints carry Hugging
    Face key names: load them through
    :func:`mgldvsr_tpu_torch.io.torch_ckpt.hf_clip_text_state_dict`."""
    return CLIPTextConfig(width=768, heads=12, layers=12, layer="last", act="quick_gelu",
                          dtype=dtype)


def empty_prompt_tokens(batch: int, context_length: int = 77, *,
                        device: torch.device | str) -> torch.Tensor:
    """Token ids of the empty prompt: [SOT, EOT, 0, ...] per row, on
    ``device`` (no default: the pipeline passes its own)."""
    row = torch.zeros(context_length, dtype=torch.int64, device=device)
    row[0] = SOT_TOKEN
    row[1] = EOT_TOKEN
    return row[None].repeat(batch, 1)


class _Attention(nn.Module):
    """Causal MHA with torch ``nn.MultiheadAttention``'s parameter names.
    Under tensor parallelism ``in_proj_weight`` holds its rank's rows
    (``tensor_parallel``: the grid) and the projection is gathered."""
    column_parallel = ("in_proj_weight",)
    tensor_parallel = None

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)

    def forward(self, x, mask):
        b, l, d = x.shape
        qkv = linear_columns(x, self.in_proj_weight, self.in_proj_bias, self.tensor_parallel)
        q, k, v = (z.reshape(b, l, self.heads, d // self.heads) for z in qkv.chunk(3, dim=-1))
        return self.out_proj(attention_math(q, k, v, mask).reshape(b, l, d))


class _MLP(nn.Module):
    def __init__(self, width: int, act: str):
        super().__init__()
        self.act = act
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)

    def forward(self, x):
        h = self.c_fc(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.c_proj(h)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, act: str):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width, heads)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width, act)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, n_blocks: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(cfg.width, cfg.heads, cfg.act) for _ in range(n_blocks)])


class OpenCLIPTextEncoder(nn.Module):
    """tokens [B, L] int64 -> context embeddings [B, L, width] float32."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        n_blocks = cfg.layers - (1 if cfg.layer == "penultimate" else 0)
        self.transformer = _Transformer(cfg, n_blocks)
        self.ln_final = LayerNorm(cfg.width, eps=1e-5)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = (self.token_embedding(tokens) + self.positional_embedding[None]).to(cfg.dtype)
        l = cfg.context_length
        causal = torch.ones(l, l, dtype=torch.bool, device=tokens.device).tril()[None, None]
        for block in self.transformer.resblocks:
            x = block(x, causal)
        return self.ln_final(x).float()

"""A self-contained CLIP BPE tokenizer.

Counterpart of ``mgldvsr_tpu/data/tokenizer.py``, copied: CLIP's byte to
unicode map, word-level BPE with ``</w>`` terminators, 49,152 merges and
the SOT / EOT specials, read from a user-supplied
``bpe_simple_vocab_16e6.txt.gz`` merges file (the one CLIP and open_clip
ship; it is not in the repo). Words are split by the stdlib ``re`` with
ASCII word classes, as in the JAX package. The restore embeds only the empty
prompt, which needs no vocabulary:
:func:`mgldvsr_tpu_torch.models.cliptext.empty_prompt_tokens`.
"""
from __future__ import annotations

import functools
import gzip
import html
import re
from typing import Iterable, List

import numpy as np

from mgldvsr_tpu_torch.models.cliptext import EOT_TOKEN, SOT_TOKEN


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable unicode char map (GPT-2 scheme)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<start_of_text>", "<end_of_text>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<start_of_text>": "<start_of_text>",
            "<end_of_text>": "<end_of_text>",
        }
        self.pat = re.compile(
            r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]"""
            r"""|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


def tokenize(
    texts,
    context_length: int = 77,
    bpe_path: str | None = None,
    tokenizer: SimpleTokenizer | None = None,
) -> np.ndarray:
    """texts -> int32 [B, context_length] with SOT/EOT framing + truncation
    (truncated rows keep EOT as the final token, matching open_clip)."""
    if isinstance(texts, str):
        texts = [texts]
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    tok = tokenizer
    for i, text in enumerate(texts):
        if text == "":
            ids: List[int] = []
        else:
            if tok is None:
                if bpe_path is None:
                    raise ValueError(
                        "non-empty prompts need a BPE vocab: pass bpe_path "
                        "(bpe_simple_vocab_16e6.txt.gz) or a tokenizer"
                    )
                tok = SimpleTokenizer(bpe_path)
            ids = tok.encode(text)
        row = [SOT_TOKEN] + ids + [EOT_TOKEN]
        if len(row) > context_length:
            row = row[:context_length]
            row[-1] = EOT_TOKEN
        out[i, : len(row)] = row
    return out

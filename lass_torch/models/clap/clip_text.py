"""CLIP-style text branch: byte-BPE tokenizer + causal transformer
(counterpart of lass_tpu/models/clap/clip_text.py).

The reference CLAP's 'transformer' text branch (open_clip/model.py:475-496:
token_embedding + positional_embedding + causal transformer + ln_final,
pooled at the end-of-text token, the highest id of a row) and its
SimpleTokenizer (open_clip/tokenizer.py:74-197: 49408 tokens, '</w>'
end-of-word markers, a 77-token context). Parameter names are open_clip's
(``token_embedding``, ``positional_embedding``,
``transformer.resblocks.N.{ln_1, attn.in_proj_*, attn.out_proj, ln_2,
mlp.c_fc, mlp.c_proj}``, ``ln_final``). As in the JAX module: LayerNorm
eps 1e-6 (flax's default; open_clip's is 1e-5), queries divided by
sqrt(head_dim) before the product, a causal mask and no padding mask,
QuickGELU, no text projection.

The BPE vocab (the standard ``bpe_simple_vocab_16e6.txt.gz``) comes from
the argument or ``LASS_TPU_CLIP_BPE_PATH``. ``regex`` and ``ftfy`` are
optional: without ``regex`` an ASCII pattern replaces the Unicode one
(the two split ASCII text alike), without ``ftfy`` text is not repaired.
"""
from __future__ import annotations

import gzip
import html
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from lass_torch.models.clap.tokenizer import bytes_to_unicode

try:
    import regex as _re
except ImportError:
    import re as _re

try:
    import ftfy as _ftfy
except ImportError:
    _ftfy = None

CLIP_PAT_UNICODE = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")
CLIP_PAT_ASCII = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+""")

_CLIP_PAT = _re.compile(
    CLIP_PAT_UNICODE if hasattr(_re, "DEFAULT_VERSION") else CLIP_PAT_ASCII,
    _re.IGNORECASE)

LN_EPS = 1e-6


def _clean(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    text = _re.sub(r"\s+", " ", text)
    return text.strip().lower()


class CLIPTokenizer:
    """SimpleTokenizer (open_clip/tokenizer.py:74-164): ids (B,
    context_length) int32, <|startoftext|> + BPE + <|endoftext|>, zeros
    after."""

    def __init__(self, bpe_path: Optional[str] = None):
        bpe_path = bpe_path or os.environ.get("LASS_TPU_CLIP_BPE_PATH")
        if bpe_path is None:
            raise FileNotFoundError(
                "CLIP BPE vocab required: pass bpe_path or set "
                "LASS_TPU_CLIP_BPE_PATH")
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in _CLIP_PAT.findall(_clean(text)):
            mapped = "".join(self.byte_encoder[b]
                             for b in chunk.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped)
                       if p in self.encoder)
        return ids

    def __call__(self, texts: Sequence[str], context_length: int = 77
                 ) -> np.ndarray:
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t)[:context_length - 2] + [self.eot]
            out[i, :len(ids)] = ids
        return out


class _Attention(nn.Module):
    """Causal multi-head self-attention with open_clip's parameter names
    (``in_proj_weight`` rows q, k, v; ``out_proj``)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        b, s, w = x.shape
        hd = w // self.heads
        qkv = nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.view(b, s, self.heads, hd).transpose(1, 2)
                   for t in qkv.split(w, dim=-1))
        scores = torch.matmul(q / math.sqrt(hd), k.transpose(-1, -2))
        scores = scores.masked_fill(~causal, torch.finfo(scores.dtype).min)
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.out_proj(ctx.transpose(1, 2).reshape(b, s, w))


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c_fc(x)
        return self.c_proj(h * torch.sigmoid(1.702 * h))  # QuickGELU


class _ResBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, LN_EPS)
        self.attn = _Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, LN_EPS)
        self.mlp = _MLP(width)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(_ResBlock(width, heads)
                                       for _ in range(layers))


class CLIPTextTransformer(nn.Module):
    """Token ids (B, S), S <= context_length -> the end-of-text row (B,
    width) of the causal transformer's output (model.py:475-496,
    :640-645)."""

    def __init__(self, vocab_size: int = 49408, width: int = 512,
                 heads: int = 8, layers: int = 12, context_length: int = 77):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(context_length, width))
        self.transformer = _Transformer(width, heads, layers)
        self.ln_final = nn.LayerNorm(width, LN_EPS)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        b, s = ids.shape
        x = self.token_embedding(ids) + self.positional_embedding[:s]
        causal = torch.ones(s, s, dtype=torch.bool,
                            device=ids.device).tril()
        for block in self.transformer.resblocks:
            x = block(x, causal)
        x = self.ln_final(x)
        return x[torch.arange(b, device=ids.device), ids.argmax(dim=-1)]

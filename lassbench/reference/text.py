"""CLAP's RoBERTa text branch and projection, plain float32, as functions of
a state dict, with the hash tokenizer that stands in for the missing
RoBERTa vocabulary.

captions -> ids ``[<s>] + one id a word + [</s>]`` (word id: 4 + the
md5 of the lower-cased word modulo vocab - 5), padded with <pad>=1 to a
multiple of ``pad_to`` -> RoBERTa (embeddings with RoBERTa's position ids,
post-LN encoder layers with exact GELU, masked attention) -> the pooler
(tanh of a dense layer on <s>) -> ``text_projection`` (Linear, ReLU,
Linear) -> L2 normalised (B, 512). Keys are a CLAP checkpoint's
``text_branch.*`` (HF ``RobertaModel`` names) and ``text_projection.*``.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BOS, PAD, EOS = 0, 1, 2
LN_EPS = 1e-5


def tokenize(texts: Sequence[str], vocab_size: int, pad_to: int,
             max_length: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    rows = []
    for t in texts:
        ids = [BOS] + [4 + int(hashlib.md5(w.encode()).hexdigest(), 16)
                       % (vocab_size - 5)
                       for w in t.lower().split()[:max_length - 2]] + [EOS]
        rows.append(ids)
    longest = max(len(r) for r in rows)
    width = min(max_length, max(pad_to, -(-longest // pad_to) * pad_to))
    ids = np.full((len(rows), width), PAD, np.int64)
    mask = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        r = r[:width]
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return ids, mask


def param_shapes(cfg: Dict) -> List[Tuple[str, tuple]]:
    h, ff = cfg["hidden_size"], cfg["intermediate_size"]
    p = "text_branch"
    out = [(f"{p}.embeddings.word_embeddings.weight",
            (cfg["vocab_size"], h)),
           (f"{p}.embeddings.position_embeddings.weight",
            (cfg["max_position_embeddings"], h)),
           (f"{p}.embeddings.token_type_embeddings.weight",
            (cfg["type_vocab_size"], h)),
           (f"{p}.embeddings.LayerNorm.weight", (h,)),
           (f"{p}.embeddings.LayerNorm.bias", (h,))]
    for i in range(cfg["num_hidden_layers"]):
        q = f"{p}.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            out += [(f"{q}.attention.self.{name}.weight", (h, h)),
                    (f"{q}.attention.self.{name}.bias", (h,))]
        out += [(f"{q}.attention.output.dense.weight", (h, h)),
                (f"{q}.attention.output.dense.bias", (h,)),
                (f"{q}.attention.output.LayerNorm.weight", (h,)),
                (f"{q}.attention.output.LayerNorm.bias", (h,)),
                (f"{q}.intermediate.dense.weight", (ff, h)),
                (f"{q}.intermediate.dense.bias", (ff,)),
                (f"{q}.output.dense.weight", (h, ff)),
                (f"{q}.output.dense.bias", (h,)),
                (f"{q}.output.LayerNorm.weight", (h,)),
                (f"{q}.output.LayerNorm.bias", (h,))]
    e = cfg["joint_embed_dim"]
    out += [(f"{p}.pooler.dense.weight", (h, h)),
            (f"{p}.pooler.dense.bias", (h,)),
            ("text_projection.0.weight", (e, h)),
            ("text_projection.0.bias", (e,)),
            ("text_projection.2.weight", (e, e)),
            ("text_projection.2.bias", (e,))]
    return out


def _ln(x, sd, key):
    return F.layer_norm(x, x.shape[-1:], sd[f"{key}.weight"],
                        sd[f"{key}.bias"], LN_EPS)


def _lin(x, sd, key):
    return x @ sd[f"{key}.weight"].t() + sd[f"{key}.bias"]


def embed(sd: Dict, cfg: Dict, ids: torch.Tensor, mask: torch.Tensor
          ) -> torch.Tensor:
    """ids, mask (B, S) int64 -> normalised (B, joint_embed_dim)."""
    p = "text_branch"
    heads = cfg["num_attention_heads"]
    not_pad = (ids != PAD).long()
    pos = torch.cumsum(not_pad, dim=1) * not_pad + PAD
    x = (sd[f"{p}.embeddings.word_embeddings.weight"][ids]
         + sd[f"{p}.embeddings.position_embeddings.weight"][pos]
         + sd[f"{p}.embeddings.token_type_embeddings.weight"][
             torch.zeros_like(ids)])
    x = _ln(x, sd, f"{p}.embeddings.LayerNorm")
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).float()
    b, s, h = x.shape
    hd = h // heads
    for i in range(cfg["num_hidden_layers"]):
        q = f"{p}.encoder.layer.{i}"

        def split(t):
            return t.view(b, s, heads, hd).transpose(1, 2)

        qq, kk, vv = (split(_lin(x, sd, f"{q}.attention.self.{n}"))
                      for n in ("query", "key", "value"))
        probs = torch.softmax(qq @ kk.transpose(-1, -2) / math.sqrt(hd)
                              + bias, dim=-1)
        ctx = (probs @ vv).transpose(1, 2).reshape(b, s, h)
        x = _ln(x + _lin(ctx, sd, f"{q}.attention.output.dense"), sd,
                f"{q}.attention.output.LayerNorm")
        ff = F.gelu(_lin(x, sd, f"{q}.intermediate.dense"))
        x = _ln(x + _lin(ff, sd, f"{q}.output.dense"), sd,
                f"{q}.output.LayerNorm")
    pooled = torch.tanh(_lin(x[:, 0], sd, f"{p}.pooler.dense"))
    z = _lin(torch.relu(_lin(pooled, sd, "text_projection.0")), sd,
             "text_projection.2")
    return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1,
                                                    keepdim=True), min=1e-12)


def embed_captions(sd: Dict, cfg: Dict, texts: Sequence[str],
                   device) -> torch.Tensor:
    ids, mask = tokenize(texts, cfg["vocab_size"], cfg["pad_to"])
    return embed(sd, cfg, torch.from_numpy(ids).to(device),
                 torch.from_numpy(mask).to(device))

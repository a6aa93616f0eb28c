"""RoBERTa text encoder in PyTorch (counterpart of
lass_tpu/models/clap/roberta.py).

Module and parameter names are those of HF ``RobertaModel``
(``embeddings.*``, ``encoder.layer.N.attention.self.{query,key,value}``,
``pooler.dense``), so the ``text_branch.*`` keys of a CLAP checkpoint load
as they are. Attention is written out as matmul + softmax with an additive
-1e9 mask, as the JAX module does; because it is masked, padding a caption
to any length at or above its own gives the same pooled output.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1


class _Embeddings(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.pad_token_id = cfg.pad_token_id

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        # roberta position ids: pad_token_id + running index over non-pad
        not_pad = (input_ids != self.pad_token_id).long()
        position_ids = torch.cumsum(not_pad, dim=1) * not_pad \
            + self.pad_token_id
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        hd = h // self.num_heads

        def heads(t):
            return t.view(b, s, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores + bias, dim=-1)
        return torch.matmul(probs, v).transpose(1, 2).reshape(b, s, h)


class _AttentionOutput(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class _Attention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.add_module("self", _SelfAttention(cfg))
        self.output = _AttentionOutput(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        ctx = getattr(self, "self")(x, bias)
        return self.output.LayerNorm(x + self.output.dense(ctx))


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class _Output(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class _Layer(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _Output(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, bias)
        ff = F.gelu(self.intermediate.dense(x), approximate="none")
        return self.output.LayerNorm(x + self.output.dense(ff))


class _Encoder(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(cfg)
                                   for _ in range(cfg.num_hidden_layers))


class RobertaModel(nn.Module):
    """input_ids/attention_mask (B, S) -> (last_hidden_state, pooler_output)."""

    def __init__(self, cfg: RobertaConfig = RobertaConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.pooler = _Dense(cfg.hidden_size, cfg.hidden_size)
        self.apply(_init_weights)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.embeddings(input_ids)
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9
                           ).to(x.dtype)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x, torch.tanh(self.pooler.dense(x[:, 0]))


def _init_weights(module: nn.Module) -> None:
    """Random init in the HF RoBERTa style (normal, std 0.02)."""
    if isinstance(module, (nn.Linear, nn.Embedding)):
        nn.init.normal_(module.weight, std=0.02)
    if isinstance(module, nn.Linear):
        nn.init.zeros_(module.bias)

"""BERT and BART-encoder text branches for CLAP (counterpart of
lass_tpu/models/clap/bert.py).

The reference CLAP picks its text branch among transformer, bert, roberta
and bart (open_clip/model.py:475-549); encode_text takes BERT's
``pooler_output`` and the mean of BART's ``encoder_last_hidden_state``
(model.py:644-676). Both are post-LN transformers with the layer the
port's RoBERTa uses (exact GELU, scores scaled after the product, an
additive -1e9 mask):

- BERT's module and parameter names are HF ``BertModel``'s, which are
  ``RobertaModel``'s (``embeddings.*``, ``encoder.layer.N.*``,
  ``pooler.dense``), so its layers are the RoBERTa layers. Position ids
  are a plain ``arange``; ``token_type_ids`` default to zeros.
- BART's are HF ``BartModel``'s encoder side (``encoder.embed_tokens``,
  ``encoder.embed_positions``, ``encoder.layernorm_embedding``,
  ``encoder.layers.N.{self_attn.{q,k,v,out}_proj, self_attn_layer_norm,
  fc1, fc2, final_layer_norm}``), so its state dict is a subset of a CLAP
  checkpoint's ``text_branch.*``. Positions are ``arange + 2`` whatever
  the padding.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lass_torch.models.clap.roberta import (
    _Dense, _Encoder, _init_weights, attend, attention_bias)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """bert-base-uncased (model.py:503 BertModel.from_pretrained)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


class _BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.LayerNorm(self.word_embeddings(input_ids)
                              + self.position_embeddings(positions)
                              + self.token_type_embeddings(token_type_ids))


class BertModel(nn.Module):
    """input_ids/attention_mask[/token_type_ids] (B, S) ->
    (last_hidden_state, pooler_output)."""

    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _BertEmbeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.pooler = _Dense(cfg.hidden_size, cfg.hidden_size)
        self.apply(_init_weights)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        bias = attention_bias(attention_mask, x.dtype)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x, torch.tanh(self.pooler.dense(x[:, 0]))


@dataclasses.dataclass(frozen=True)
class BartConfig:
    """facebook/bart-base's encoder (model.py:533
    BartModel.from_pretrained); field names as BertConfig's."""

    vocab_size: int = 50265
    hidden_size: int = 768  # d_model
    num_hidden_layers: int = 6  # encoder_layers
    num_attention_heads: int = 12
    intermediate_size: int = 3072  # encoder_ffn_dim
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    position_offset: int = 2  # HF BartLearnedPositionalEmbedding's offset


class _BartAttention(nn.Module):
    def __init__(self, cfg: BartConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(h, h)
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.out_proj(attend(self.q_proj(x), self.k_proj(x),
                                    self.v_proj(x), bias, self.num_heads))


class _BartLayer(nn.Module):
    def __init__(self, cfg: BartConfig):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn = _BartAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(h, eps)
        self.fc1 = nn.Linear(h, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, h)
        self.final_layer_norm = nn.LayerNorm(h, eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.self_attn_layer_norm(x + self.self_attn(x, bias))
        ff = self.fc2(F.gelu(self.fc1(x), approximate="none"))
        return self.final_layer_norm(x + ff)


class _BartEncoder(nn.Module):
    def __init__(self, cfg: BartConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.embed_positions = nn.Embedding(
            cfg.max_position_embeddings + cfg.position_offset,
            cfg.hidden_size)
        self.layernorm_embedding = nn.LayerNorm(cfg.hidden_size,
                                                cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_BartLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))


class BartEncoderModel(nn.Module):
    """input_ids/attention_mask (B, S) -> the encoder's last_hidden_state
    (B, S, H): token embeddings (scale 1, as bart-base) plus learned
    positions, layernorm_embedding, then the post-LN layers."""

    def __init__(self, cfg: BartConfig = BartConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = _BartEncoder(cfg)
        self.apply(_init_weights)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                ) -> torch.Tensor:
        enc = self.encoder
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = enc.layernorm_embedding(
            enc.embed_tokens(input_ids)
            + enc.embed_positions(positions + self.cfg.position_offset))
        bias = attention_bias(attention_mask, x.dtype)
        for layer in enc.layers:
            x = layer(x, bias)
        return x

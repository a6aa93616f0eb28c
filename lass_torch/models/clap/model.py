"""CLAP text tower for LASS: RoBERTa pooler output -> 2-layer MLP
projection -> L2 normalise (counterpart of ``CLAPTextEncoder`` in
lass_tpu/models/clap/model.py). The BERT, BART and audio towers are later
slices."""
from __future__ import annotations

import torch
import torch.nn as nn

from lass_torch.models.clap.roberta import RobertaConfig, RobertaModel


class MLPProjection(nn.Sequential):
    """Linear -> ReLU -> Linear into the joint space; indices 0 and 2 are
    the CLAP checkpoint's ``text_projection.{0,2}``."""

    def __init__(self, in_dim: int, out_dim: int = 512):
        super().__init__(nn.Linear(in_dim, out_dim), nn.ReLU(),
                         nn.Linear(out_dim, out_dim))


class CLAPTextEncoder(nn.Module):
    """Caption token ids -> normalized (B, joint_embed_dim) embedding.
    State-dict keys: ``text_branch.*`` and ``text_projection.*``."""

    def __init__(self, roberta_cfg: RobertaConfig = RobertaConfig(),
                 joint_embed_dim: int = 512):
        super().__init__()
        self.text_branch = RobertaModel(roberta_cfg)
        self.text_projection = MLPProjection(roberta_cfg.hidden_size,
                                             joint_embed_dim)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                ) -> torch.Tensor:
        _, pooled = self.text_branch(input_ids, attention_mask)
        proj = self.text_projection(pooled)
        norm = torch.linalg.vector_norm(proj, dim=-1, keepdim=True)
        return proj / torch.clamp(norm, min=1e-12)

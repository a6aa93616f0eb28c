"""CLAP towers for LASS (counterpart of lass_tpu/models/clap/model.py):

- text: RoBERTa pooler output -> 2-layer MLP projection -> L2 normalise;
- audio: HTSAT ``embedding`` -> 2-layer MLP projection -> L2 normalise
  (the reference's get_audio_embedding, open_clip/model.py:754-781).

State-dict names are a CLAP checkpoint's (``text_branch.*``,
``text_projection.{0,2}``, ``audio_branch.*``, ``audio_projection.{0,2}``).
The BERT and BART text towers and the PANN audio tower are later slices."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from lass_torch.models.clap.htsat import HTSAT, HTSATConfig
from lass_torch.models.clap.roberta import RobertaConfig, RobertaModel


class MLPProjection(nn.Sequential):
    """Linear -> ReLU -> Linear into the joint space; indices 0 and 2 are
    the CLAP checkpoint's ``text_projection.{0,2}`` /
    ``audio_projection.{0,2}``."""

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
        return _normalize(self.text_projection(pooled))


def _normalize(x: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-12)


class CLAPAudioProjection(nn.Module):
    """HTSAT embedding -> normalized (B, joint_embed_dim) embedding; keys
    ``audio_projection.{0,2}``."""

    def __init__(self, in_dim: int = 1024, joint_embed_dim: int = 512):
        super().__init__()
        self.audio_projection = MLPProjection(in_dim, joint_embed_dim)

    def forward(self, audio_embedding: torch.Tensor) -> torch.Tensor:
        return _normalize(self.audio_projection(audio_embedding))


class CLAPAudioEncoder(nn.Module):
    """48 kHz waveform (B, L) -> normalized (B, joint_embed_dim) embedding:
    HTSAT ``embedding``, ``audio_projection``, L2 normalise. A
    fusion-enabled HTSAT takes ``mel_fusion`` (B, 4, T, n_mels) and
    ``longer`` (B,) instead of a waveform. Keys ``audio_branch.*`` and
    ``audio_projection.{0,2}``. Eval only (see ``HTSAT``)."""

    def __init__(self, htsat_cfg: Optional[HTSATConfig] = None,
                 joint_embed_dim: int = 512):
        super().__init__()
        cfg = htsat_cfg or HTSATConfig()
        self.audio_branch = HTSAT(cfg)
        self.audio_projection = MLPProjection(cfg.num_features,
                                              joint_embed_dim)

    def forward(self, waveform: Optional[torch.Tensor] = None, *,
                mel_fusion: Optional[torch.Tensor] = None,
                longer: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.audio_branch(waveform, mel_fusion=mel_fusion,
                                longer=longer)
        return _normalize(self.audio_projection(out["embedding"]))

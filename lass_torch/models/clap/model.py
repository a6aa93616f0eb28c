"""CLAP towers for LASS (counterpart of lass_tpu/models/clap/model.py):

- text: RoBERTa pooler output -> 2-layer MLP projection -> L2 normalise;
- audio: HTSAT's or a PANN's ``embedding`` -> 2-layer MLP projection ->
  L2 normalise (the reference's get_audio_embedding,
  open_clip/model.py:754-781; PANN model configs, :463-464).

State-dict names are a CLAP checkpoint's (``text_branch.*``,
``text_projection.{0,2}``, ``audio_branch.*``, ``audio_projection.{0,2}``).
The audio towers' train mode (CLAP pretraining) takes a CPU
``generator`` for its random draws. The BERT and BART text towers are a
later slice."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from lass_torch.models.clap.htsat import HTSAT, HTSATConfig
from lass_torch.models.clap.pann import PANN, PANNConfig
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


class _AudioTower(nn.Module):
    """An audio branch's ``embedding`` -> ``audio_projection`` -> L2
    normalise; keys ``audio_branch.*`` and ``audio_projection.{0,2}``."""

    def __init__(self, branch: nn.Module, width: int, joint_embed_dim: int):
        super().__init__()
        self.audio_branch = branch
        self.audio_projection = MLPProjection(width, joint_embed_dim)

    def forward(self, waveform: Optional[torch.Tensor] = None, *,
                mel_fusion: Optional[torch.Tensor] = None,
                longer: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        out = self.audio_branch(waveform, mel_fusion=mel_fusion,
                                longer=longer, generator=generator)
        return _normalize(self.audio_projection(out["embedding"]))


class CLAPAudioEncoder(_AudioTower):
    """48 kHz waveform (B, L) -> normalized (B, joint_embed_dim) embedding
    through HTSAT. A fusion-enabled HTSAT takes ``mel_fusion`` (B, 4, T,
    n_mels) and ``longer`` (B,) instead of a waveform."""

    def __init__(self, htsat_cfg: Optional[HTSATConfig] = None,
                 joint_embed_dim: int = 512):
        cfg = htsat_cfg or HTSATConfig()
        super().__init__(HTSAT(cfg), cfg.num_features, joint_embed_dim)


class CLAPPANNAudioEncoder(_AudioTower):
    """The same through a PANN (Cnn14 by default) instead of HTSAT
    (model.py:463-464 ``if audio_cfg.model_type == "PANN"``)."""

    def __init__(self, pann_cfg: Optional[PANNConfig] = None,
                 joint_embed_dim: int = 512):
        cfg = pann_cfg or PANNConfig()
        super().__init__(PANN(cfg), cfg.embedding_dim, joint_embed_dim)

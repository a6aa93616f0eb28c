"""The CLAP linear probe (counterpart of
lass_tpu/models/clap/linear_probe.py): an audio trunk (HTSAT or a PANN +
``audio_projection``, without the L2 normalise) and a classifier head.

The reference's open_clip/linear_probe.py:7-66 and model.py:27-44
(MLPLayers). Names are the reference's: the trunk under ``clap_model.``,
the head under ``lp_layer.`` (a Linear, or MLPLayers' Sequential whose
Linear i sits at index 3 * i).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from lass_torch.models.clap.htsat import HTSAT, HTSATConfig, device_generator
from lass_torch.models.clap.model import MLPProjection
from lass_torch.models.clap.pann import PANN, PANNConfig
from lass_torch.nn.layers import dropout


class _Dropout(nn.Module):
    """Dropout whose mask comes from the generator handed to the probe's
    forward (``lass_torch.nn.layers.dropout``)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.p, self.generator) if self.training else x


class MLPLayers(nn.Sequential):
    """Linear -> ReLU -> Dropout, repeated, the last Linear bare
    (model.py:27-44)."""

    def __init__(self, units: Sequence[int] = (512, 512, 512),
                 dropout_p: float = 0.1):
        layers = []
        for u0, u1 in zip(units[:-1], units[1:]):
            layers += [nn.Linear(u0, u1), nn.ReLU(), _Dropout(dropout_p)]
        super().__init__(*layers[:-2])


class _ClapAudioTrunk(nn.Module):
    """``audio_branch`` + ``audio_projection``, unnormalized (the probe
    reads the raw projection, linear_probe.py:58-62)."""

    def __init__(self, audio_model: str, audio_cfg, joint_embed_dim: int):
        super().__init__()
        if audio_model.upper() == "HTSAT":
            cfg = audio_cfg or HTSATConfig()
            self.audio_branch = HTSAT(cfg)
            width = cfg.num_features
        elif audio_model.upper() == "PANN":
            cfg = audio_cfg or PANNConfig()
            self.audio_branch = PANN(cfg)
            width = cfg.embedding_dim
        else:
            raise ValueError(f"unknown audio_model {audio_model!r}")
        self.audio_projection = MLPProjection(width, joint_embed_dim)

    def forward(self, waveform, mel_fusion=None, longer=None,
                generator=None) -> torch.Tensor:
        out = self.audio_branch(waveform, mel_fusion=mel_fusion,
                                longer=longer, generator=generator)
        return self.audio_projection(out["embedding"])


class LinearProbe(nn.Module):
    """Audio waveform -> class logits (or activated probabilities).

    ``freeze`` (the reference's, linear_probe.py:28-30, 54-56): the trunk
    stays in eval mode whatever ``.train()`` says (running statistics, no
    spec-augment) and gets no gradient; only ``lp_layer`` trains."""

    def __init__(self, out_ch: int, mlp: bool = False, freeze: bool = True,
                 in_ch: int = 512, act: Optional[str] = None,
                 audio_model: str = "HTSAT",
                 audio_cfg: Union[HTSATConfig, PANNConfig, None] = None):
        super().__init__()
        if act not in (None, "None", "relu", "elu", "sigmoid", "softmax"):
            raise ValueError(f"unknown act {act!r}")
        self.freeze, self.act = freeze, act
        self.clap_model = _ClapAudioTrunk(audio_model, audio_cfg, in_ch)
        self.lp_layer = (MLPLayers((in_ch, in_ch * 2, out_ch)) if mlp
                         else nn.Linear(in_ch, out_ch))
        if freeze:
            self.clap_model.requires_grad_(False)

    def train(self, mode: bool = True) -> "LinearProbe":
        super().train(mode)
        if self.freeze:
            self.clap_model.eval()
        return self

    def forward(self, waveform: Optional[torch.Tensor] = None, *,
                mel_fusion: Optional[torch.Tensor] = None,
                longer: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` (CPU) draws the trunk's train-mode stripes and the
        head's dropout masks (on a generator of the input's device seeded
        from it)."""
        if self.freeze:
            with torch.no_grad():
                feats = self.clap_model(waveform, mel_fusion, longer)
        else:
            feats = self.clap_model(waveform, mel_fusion, longer, generator)
        drops = [m for m in self.lp_layer.modules()
                 if isinstance(m, _Dropout)]
        if drops and self.training:
            gen = device_generator(generator, feats.device)
            for m in drops:
                m.generator = gen
        out = self.lp_layer(feats)
        if self.act == "relu":
            return F.relu(out)
        if self.act == "elu":
            return F.elu(out)
        if self.act == "sigmoid":
            return torch.sigmoid(out)
        if self.act == "softmax":
            return torch.softmax(out, dim=-1)
        return out

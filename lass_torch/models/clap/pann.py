"""PANN audio towers, Cnn14 / Cnn10 / Cnn6 (counterpart of
lass_tpu/models/clap/pann.py): the CLAP audio branch that replaces HTSAT
in PANN model configs (reference models/CLAP/open_clip/pann_model.py
:171-684, open_clip/model.py:463-464).

Per variant (pann_model.py):

- Cnn14 (:171-434): six double-3x3 VGG blocks, channels 64..2048 (the
  last unpooled), fc1 2048, fine-grained repeat 32;
- Cnn10 (:556-684): five double-3x3 blocks, channels 64..1024, fc1 1024,
  repeat 32;
- Cnn6 (:436-554): four single-5x5 blocks, channels 64..512, fc1 512,
  repeat 16.

All share: log-mel (``lass_torch.dsp.mel``) -> bn0 over the mel bins ->
the conv stack (2x2 average pools, dropout 0.2 after each block) -> mean
over frequency -> the clip path (max + mean over time, dropout 0.5, fc1 +
ReLU = ``embedding`` after another dropout 0.5; ``clipwise_output`` from
fc1's output before that dropout) and the fine-grained path (k3/s1/p1 max
+ average pools over time, fc1 + ReLU, repeated in time).

Fusion configurations (pann_model.py:244-272, :300-389) take the
(B, 4, T, n_mels) mel stack and a (B,) ``longer`` flag: 1D fusion before
the conv stack through the stride-3 ``mel_conv1d`` (HTSAT's), 2D fusion
after conv_block1 through ``mel_conv2d`` (5x5, stride (6, 2), BN, ReLU)
with the chunks concatenated in time, chunk-major; ``channel_map`` feeds
the four channels to conv_block1. As in the JAX package, the local branch
runs for every item and ``torch.where(longer)`` picks.

Train mode (``.train()``): batch statistics in every BatchNorm,
spec-augment after bn0 (after the 1D fusion; on the 4-channel stack, its
stripes shared by the channels, for 2D and channel_map) with its stripes
drawn from ``generator`` on the CPU (``htsat.spec_augment``), and dropout
whose masks come from a generator on the activations' device seeded from
``generator``. NCHW activations; parameter names are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lass_torch.dsp.mel import LogMelConfig, log_mel_spectrogram
from lass_torch.models.clap.fusion import fusion_block
from lass_torch.models.clap.htsat import (
    FUSION_1D, FUSION_2D, device_generator, fuse_1d, spec_augment)
from lass_torch.nn.layers import BatchNorm, dropout

_VARIANTS = {
    # channels, double_conv, kernel, fc_dim, interpolate_ratio
    "Cnn14": ((64, 128, 256, 512, 1024, 2048), True, 3, 2048, 32),
    "Cnn10": ((64, 128, 256, 512, 1024), True, 3, 1024, 32),
    "Cnn6": ((64, 128, 256, 512), False, 5, 512, 16),
}


@dataclasses.dataclass(frozen=True)
class PANNConfig:
    model_name: str = "Cnn14"
    classes_num: int = 527
    mel: LogMelConfig = LogMelConfig()
    enable_fusion: bool = False
    fusion_type: str = "None"

    @property
    def embedding_dim(self) -> int:
        return _VARIANTS[self.model_name][3]

    @property
    def interpolate_ratio(self) -> int:
        return _VARIANTS[self.model_name][4]


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    """k x k, stride 1, padding k // 2, no bias, xavier-uniform (the JAX
    package's ``conv2d``)."""
    conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)
    nn.init.xavier_uniform_(conv.weight)
    return conv


class PANNConvBlock(nn.Module):
    """ConvBlock (double 3x3, pann_model.py:33-84) or ConvBlock5x5
    (single 5x5, :86-124): conv, BN (momentum 0.1), ReLU (twice for the
    double block), then a pool x pool average pool."""

    def __init__(self, cin: int, cout: int, double: bool, kernel: int):
        super().__init__()
        self.conv1 = _conv(cin, cout, kernel)
        self.bn1 = BatchNorm(cout, 0.1)
        if double:
            self.conv2 = _conv(cout, cout, kernel)
            self.bn2 = BatchNorm(cout, 0.1)
        self.double = double

    def forward(self, x: torch.Tensor, pool: int) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        if self.double:
            x = F.relu(self.bn2(self.conv2(x)))
        return F.avg_pool2d(x, pool) if pool > 1 else x


class PANN(nn.Module):
    """waveform (B, L) -> {'embedding', 'clipwise_output',
    'fine_grained_embedding'}; fusion configurations take ``mel_fusion``
    and ``longer`` instead."""

    def __init__(self, cfg: PANNConfig = PANNConfig()):
        super().__init__()
        self.cfg = cfg
        channels, double, kernel, fc_dim, _ = _VARIANTS[cfg.model_name]
        fusion = cfg.enable_fusion
        self.fusion_1d = fusion and cfg.fusion_type in FUSION_1D
        self.fusion_2d = fusion and cfg.fusion_type in FUSION_2D
        if fusion and not (self.fusion_1d or self.fusion_2d
                           or cfg.fusion_type == "channel_map"):
            raise NotImplementedError(cfg.fusion_type)
        m = cfg.mel.n_mels
        self.bn0 = BatchNorm(m, dim=-1)  # over the mel axis
        cin = 4 if fusion and cfg.fusion_type == "channel_map" else 1
        for i, ch in enumerate(channels):
            self.add_module(f"conv_block{i + 1}",
                            PANNConvBlock(cin, ch, double, kernel))
            cin = ch
        self.fc1 = nn.Linear(channels[-1], fc_dim)
        self.fc_audioset = nn.Linear(fc_dim, cfg.classes_num)
        if self.fusion_1d:
            self.mel_conv1d = nn.Sequential(
                nn.Conv1d(m, m, 5, stride=3, padding=2), BatchNorm(m, 0.1))
            self.fusion_model = fusion_block(cfg.fusion_type, m, 1)
        if self.fusion_2d:
            self.mel_conv2d = nn.Sequential(
                nn.Conv2d(1, 64, 5, stride=(6, 2), padding=2),
                BatchNorm(64, 0.1), nn.ReLU())
            self.fusion_model = fusion_block(cfg.fusion_type, 64, 2)

    def forward(self, waveform: Optional[torch.Tensor] = None, *,
                mel_fusion: Optional[torch.Tensor] = None,
                longer: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        channels, _, _, _, ratio = _VARIANTS[cfg.model_name]
        train = self.training
        if cfg.enable_fusion:
            if mel_fusion is None or longer is None:
                raise ValueError("fusion-enabled PANN takes "
                                 "mel_fusion=(B,4,T,M) and longer=(B,)")
            mel4 = self.bn0(mel_fusion.float())
            if self.fusion_1d:
                mel = fuse_1d(self.mel_conv1d, self.fusion_model, mel4,
                              longer)
                if train:
                    mel = spec_augment(mel, generator)
                x = mel[:, None]  # (B, 1, T, M)
            else:
                x = spec_augment(mel4, generator) if train else mel4
        else:
            mel = self.bn0(log_mel_spectrogram(waveform, cfg.mel))
            if train:
                mel = spec_augment(mel, generator)
            x = mel[:, None]
        drop_gen = device_generator(generator, x.device) if train else None

        def drop(h, p):
            return dropout(h, p, drop_gen) if train else h

        for i in range(len(channels)):
            pool = 1 if (cfg.model_name == "Cnn14"
                         and i == len(channels) - 1) else 2
            block = getattr(self, f"conv_block{i + 1}")
            if i == 0 and self.fusion_2d:
                x = self._fuse_2d(x, block(x[:, 0:1], pool), longer)
            else:
                x = block(x, pool)
            x = drop(x, 0.2)

        x = x.mean(dim=3)  # over frequency: (B, C, T')
        # the fine-grained path (pann_model.py:406-412)
        lat = F.max_pool1d(x, 3, 1, 1) + F.avg_pool1d(x, 3, 1, 1)
        lat = F.relu(self.fc1(lat.transpose(1, 2)))  # (B, T', fc)
        fine = lat.repeat_interleave(ratio, dim=1)

        h = drop(x.amax(dim=2) + x.mean(dim=2), 0.5)
        h = F.relu(self.fc1(h))
        return {"embedding": drop(h, 0.5),
                "clipwise_output": torch.sigmoid(self.fc_audioset(h)),
                "fine_grained_embedding": fine}

    def _fuse_2d(self, x: torch.Tensor, glob: torch.Tensor,
                 longer: torch.Tensor) -> torch.Tensor:
        """The local channels through mel_conv2d, concatenated in time
        chunk-major, cropped or zero-padded to conv_block1's height, fused
        into its output (pann_model.py:259-265, :352-389)."""
        b, _, t, f = x.shape
        loc = self.mel_conv2d(x[:, 1:4].reshape(b * 3, 1, t, f))
        c, th, tw = loc.shape[1:]
        loc = loc.reshape(b, 3, c, th, tw).permute(0, 2, 1, 3, 4).reshape(
            b, c, 3 * th, tw)
        gh = glob.shape[2]
        loc = loc[:, :, :gh] if 3 * th >= gh else F.pad(
            loc, (0, 0, 0, gh - 3 * th))
        if loc.shape[3] != glob.shape[3]:
            raise ValueError(f"mel_conv2d width {loc.shape[3]} != "
                             f"conv_block1's {glob.shape[3]}")
        fused = self.fusion_model(glob, loc)
        return torch.where(longer.to(torch.bool)[:, None, None, None], fused,
                           glob)


def Cnn14(cfg: Optional[PANNConfig] = None) -> PANN:
    return PANN(dataclasses.replace(cfg or PANNConfig(), model_name="Cnn14"))


def Cnn10(cfg: Optional[PANNConfig] = None) -> PANN:
    return PANN(dataclasses.replace(cfg or PANNConfig(), model_name="Cnn10"))


def Cnn6(cfg: Optional[PANNConfig] = None) -> PANN:
    return PANN(dataclasses.replace(cfg or PANNConfig(), model_name="Cnn6"))

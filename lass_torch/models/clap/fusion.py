"""Attentional feature fusion and the long-audio mel-fusion features
(counterpart of lass_tpu/models/clap/fusion.py).

The reference's feature_fusion.py (DAF :11-21, iAFF :23-131, AFF :133-192,
WACV'21 Attentional Feature Fusion), channels first as there: 1D inputs
(B, C, T) take Conv1d 1x1 branches, 2D inputs (B, C, H, W) Conv2d 1x1
ones, each Conv -> BN -> ReLU -> Conv -> BN, the global branch after an
adaptive average pool. Module indices are the reference's, so the state
dict has its names. As in the JAX package:

- iAFF reuses ``global_att`` in its second round (feature_fusion.py:124);
  the reference's unused ``global_att2`` is not built;
- the reference's batch-of-1 duplication (feature_fusion.py:114-117) is
  not reproduced: eval-mode BN takes any batch.

``build_mel_fusion`` is the 'fusion' branch of get_audio_features
(training/data.py:467-517), a numpy copy of the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from lass_torch.nn.layers import BatchNorm


class DAF(nn.Module):
    """Direct-add fusion."""

    def forward(self, x: torch.Tensor, residual: torch.Tensor
                ) -> torch.Tensor:
        return x + residual


def _att_branch(channels: int, inter: int, dims: int,
                global_pool: bool) -> nn.Sequential:
    conv = nn.Conv1d if dims == 1 else nn.Conv2d
    pool = [nn.AdaptiveAvgPool1d(1) if dims == 1 else nn.AdaptiveAvgPool2d(1)]
    return nn.Sequential(*(pool if global_pool else []),
                         conv(channels, inter, 1), BatchNorm(inter, 0.1),
                         nn.ReLU(), conv(inter, channels, 1),
                         BatchNorm(channels, 0.1))


class AFF(nn.Module):
    def __init__(self, channels: int = 64, r: int = 4, dims: int = 2):
        super().__init__()
        inter = channels // r
        self.local_att = _att_branch(channels, inter, dims, False)
        self.global_att = _att_branch(channels, inter, dims, True)

    def forward(self, x: torch.Tensor, residual: torch.Tensor
                ) -> torch.Tensor:
        xa = x + residual
        wei = torch.sigmoid(self.local_att(xa) + self.global_att(xa))
        return 2 * x * wei + 2 * residual * (1 - wei)


class iAFF(nn.Module):
    def __init__(self, channels: int = 64, r: int = 4, dims: int = 2):
        super().__init__()
        inter = channels // r
        self.local_att = _att_branch(channels, inter, dims, False)
        self.global_att = _att_branch(channels, inter, dims, True)
        self.local_att2 = _att_branch(channels, inter, dims, False)

    def forward(self, x: torch.Tensor, residual: torch.Tensor
                ) -> torch.Tensor:
        xa = x + residual
        wei = torch.sigmoid(self.local_att(xa) + self.global_att(xa))
        xi = x * wei + residual * (1 - wei)
        wei2 = torch.sigmoid(self.local_att2(xi) + self.global_att(xi))
        return x * wei2 + residual * (1 - wei2)


def fusion_block(fusion_type: str, channels: int, dims: int) -> nn.Module:
    """The block a fusion type names ('daf' / 'aff' / 'iaff' + '_1d' or
    '_2d')."""
    kind = fusion_type.split("_")[0]
    if kind == "daf":
        return DAF()
    if kind == "aff":
        return AFF(channels, dims=dims)
    if kind == "iaff":
        return iAFF(channels, dims=dims)
    raise NotImplementedError(fusion_type)


def build_mel_fusion(mel: np.ndarray, chunk_frames: int,
                     rng: Optional[np.random.Generator] = None
                     ) -> tuple:
    """(T, M) log-mel of a LONG clip -> ((4, chunk_frames, M), longer):
    three randomly placed chunks (front, middle and back thirds) + the
    global mel resized to chunk_frames."""
    rng = rng or np.random.default_rng()
    total = mel.shape[0]
    if chunk_frames >= total:
        stack = np.stack([mel, mel, mel, mel])
        return stack.astype(np.float32), False
    ranges = np.array_split(np.arange(0, total - chunk_frames + 1), 3)
    picks = []
    for part in ranges:
        picks.append(int(rng.choice(part)) if len(part) else 0)
    chunks = [mel[p:p + chunk_frames] for p in picks]
    # the global shrink: bilinear over time, align_corners=False, which is
    # torchvision.transforms.Resize's sampling (training/data.py:507) when
    # the mel-bin axis keeps its size
    src = (np.arange(chunk_frames) + 0.5) * (total / chunk_frames) - 0.5
    src = np.clip(src, 0.0, total - 1)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, total - 1)
    frac = (src - lo)[:, None]
    shrink = mel[lo] * (1 - frac) + mel[hi] * frac
    return (np.stack(chunks + [shrink]).astype(np.float32), True)

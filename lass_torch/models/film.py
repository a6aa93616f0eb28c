"""FiLM condition generator as ONE fused Linear.

The reference builds ~40 separate ``nn.Linear(512, C_i)`` modules, one per
conditioned BatchNorm, and names them by their path joined with '->'
(``film.encoder_block1->conv_block1->beta1``). Here they are one
512 -> sum(C_i) Linear whose output is split back into the nested beta
dict. The spec lists (path, features, used) in the reference's traversal
order, which is also the order of the fused weight's rows; entries with
used=False are the reference's dead decoder ``beta2`` Linears (the decoder
never reads them) kept so checkpoints round-trip.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn as nn

FilmEntry = Tuple[Tuple[str, ...], int, bool]  # (path, features, used)

_ENCODER_CHANNELS = [
    # (name, in_ch, out_ch)
    ("encoder_block1", 32, 32),
    ("encoder_block2", 32, 64),
    ("encoder_block3", 64, 128),
    ("encoder_block4", 128, 256),
    ("encoder_block5", 256, 384),
    ("encoder_block6", 384, 384),
    ("conv_block7a", 384, 384),
]

_DECODER_CHANNELS = [
    ("decoder_block1", 384, 384),
    ("decoder_block2", 384, 384),
    ("decoder_block3", 384, 256),
    ("decoder_block4", 256, 128),
    ("decoder_block5", 128, 64),
    ("decoder_block6", 64, 32),
]


def resunet30_film_spec() -> Tuple[FilmEntry, ...]:
    """FiLM spec for ResUNet30 in the reference's get_film_meta order."""
    spec = []
    for name, in_ch, out_ch in _ENCODER_CHANNELS:
        spec.append(((name, "conv_block1", "beta1"), in_ch, True))
        spec.append(((name, "conv_block1", "beta2"), out_ch, True))
    for name, in_ch, out_ch in _DECODER_CHANNELS:
        spec.append(((name, "beta1"), in_ch, True))
        spec.append(((name, "beta2"), in_ch, False))  # dead in reference too
        spec.append(((name, "conv_block2", "beta1"), out_ch * 2, True))
        spec.append(((name, "conv_block2", "beta2"), out_ch, True))
    return tuple(spec)


def multistft_film_spec(win_lengths: Sequence[int]
                        ) -> Tuple[FilmEntry, ...]:
    """FiLM spec of the multi-resolution variant, lass_tpu's
    ``multistft_film_spec`` entry for entry: one encoder_block1 branch per
    window (``encoder_block1s/<win>``), then the shared trunk, whose
    encoder_block2 and decoder_block6 take the 32 * len(wins) fused
    channels."""
    spec = []
    for wl in win_lengths:
        for beta in ("beta1", "beta2"):
            spec.append((("encoder_block1s", str(wl), "conv_block1", beta),
                         32, True))
    fused = 32 * len(win_lengths)
    trunk_enc = [("encoder_block2", fused, 64)] + _ENCODER_CHANNELS[2:]
    for name, in_ch, out_ch in trunk_enc:
        spec.append(((name, "conv_block1", "beta1"), in_ch, True))
        spec.append(((name, "conv_block1", "beta2"), out_ch, True))
    for name, in_ch, out_ch in _DECODER_CHANNELS:
        skip_ch = fused if name == "decoder_block6" else out_ch
        spec.append(((name, "beta1"), in_ch, True))
        spec.append(((name, "beta2"), in_ch, False))
        spec.append(((name, "conv_block2", "beta1"), out_ch + skip_ch, True))
        spec.append(((name, "conv_block2", "beta2"), out_ch, True))
    return tuple(spec)


class FusedFiLM(nn.Linear):
    """(B, condition_size) float32 -> nested dict of (B, C_i) betas via one
    matmul. ``weight`` is (sum C_i, condition_size), rows in spec order."""

    def __init__(self, spec: Tuple[FilmEntry, ...],
                 condition_size: int = 512):
        super().__init__(condition_size, sum(f for _, f, _ in spec))
        self.spec = spec
        # per-slice xavier-uniform, as each reference Linear has its own fan
        with torch.no_grad():
            offset = 0
            for _, feat, _ in spec:
                nn.init.xavier_uniform_(self.weight[offset:offset + feat])
                offset += feat
            nn.init.zeros_(self.bias)

    def forward(self, condition: torch.Tensor) -> Dict[str, Any]:
        flat = super().forward(condition.float())
        out: Dict[str, Any] = {}
        offset = 0
        for path, feat, _used in self.spec:
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = flat[:, offset:offset + feat]
            offset += feat
        return out

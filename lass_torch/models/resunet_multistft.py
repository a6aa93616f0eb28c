"""Multi-resolution-STFT ResUNet30 (counterpart of
lass_tpu/models/resunet_multistft.py).

The input is the precomputed-STFT pipeline's: per window length, the
mixture's (mag, cos, sin), each (B, T, F_win, C) as stored
(``lass_torch/data/precompute.py``). Per window: ``bn0_<win>`` over that
window's bins in float32, the Nyquist bin dropped, the bins brought onto
the 512 window's grid of 256 (``adapt_freq``: finer grids mean-pooled,
coarser ones repeated), time padded to a multiple of 32, then the cast to
the compute dtype, ``pre_conv_<win>`` and ``encoder_block1_<win>``. The
branches meet by channel concat in the shared trunk (encoder_block2 to
decoder_block6, decoder_block6 taking the 32 * len(wins) fused skip) and
``after_conv``. The mask is applied to the 512 window's spectrum, rebuilt
as re = mag * cos, im = mag * sin in float32, by the mask kernel (B1) and
inverted with a 512-point ISTFT.

lass_tpu pads the 256-bin logits to 257 and applies the mask at F = 257.
Here the mask kernel takes the 256 bins and the ISTFT treats the Nyquist
bin as zero (``apply_mask_and_reconstruct``): zero logits there give a
zero phase-rotation factor, so the two are the same function.

Layout is NCHW inside; module names are the flax names (``bn0_512``,
``pre_conv_512``, ``encoder_block1_512``, ``encoder_block2``, ...,
``after_conv``, ``film``), so ``lass_torch.convert.from_jax`` maps name to
name.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lass_torch.dsp.stft import STFTConfig
from lass_torch.models.film import FusedFiLM, multistft_film_spec
from lass_torch.models.resunet import (
    TIME_DOWNSAMPLE_RATIO, _DTYPES, apply_mask_and_reconstruct)
from lass_torch.nn.blocks import DecoderBlockRes1B, EncoderBlockRes1B
from lass_torch.nn.layers import BatchNorm, Conv2d

RECON_WIN = 512  # the window whose spectrum the mask is applied to

# the shared trunk after the per-window branches: (name, in, out, stride);
# encoder_block2's input is the fused branches' width
_TRUNK_ENC = [("encoder_block3", 64, 128, (2, 2)),
              ("encoder_block4", 128, 256, (2, 2)),
              ("encoder_block5", 256, 384, (2, 2)),
              ("encoder_block6", 384, 384, (1, 2)),
              ("conv_block7a", 384, 384, (1, 1))]
_TRUNK_DEC = [("decoder_block1", 384, 384, (1, 2)),
              ("decoder_block2", 384, 384, (2, 2)),
              ("decoder_block3", 384, 256, (2, 2)),
              ("decoder_block4", 256, 128, (2, 2)),
              ("decoder_block5", 128, 64, (2, 2))]


def adapt_freq(x: torch.Tensor, target_bins: int) -> torch.Tensor:
    """(..., F) -> (..., target_bins): mean-pool a finer grid, repeat each
    bin of a coarser one (the standard windows' ratios are powers of 2)."""
    f = x.shape[-1]
    if f == target_bins:
        return x
    if f > target_bins:
        ratio = f // target_bins
        return x[..., :ratio * target_bins].unflatten(
            -1, (target_bins, ratio)).mean(-1)
    return x.repeat_interleave(target_bins // f, dim=-1)


class MultiSTFTResUNet30(nn.Module):
    """``forward(input_dict, target_length) -> {'waveform': (B, C, L)}``;
    input_dict: {'stft_mixture_mag' | 'stft_mixture_cos' |
    'stft_mixture_sin': {win: (B, T, F_win, C) float32}, 'condition':
    (B, condition_size)}. Train or eval mode is the module's own."""

    def __init__(self, input_channels: int = 1, output_channels: int = 1,
                 condition_size: int = 512,
                 win_lengths: Tuple[int, ...] = (256, 512, 2048),
                 hop_size: int = 160, K: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if RECON_WIN not in win_lengths:
            raise ValueError(f"win_lengths must hold the {RECON_WIN} window "
                             f"the mask is applied to, got {win_lengths}")
        self.win_lengths = tuple(int(w) for w in win_lengths)
        self.output_channels = output_channels
        self.K = K
        self.compute_dtype = compute_dtype
        self.recon_cfg = STFTConfig(n_fft=RECON_WIN, hop_length=hop_size)
        self.film = FusedFiLM(multistft_film_spec(self.win_lengths),
                              condition_size)
        for wl in self.win_lengths:
            self.add_module(f"bn0_{wl}", BatchNorm(wl // 2 + 1, dim=3))
            self.add_module(f"pre_conv_{wl}",
                            Conv2d(input_channels, 32, (1, 1)))
            self.add_module(f"encoder_block1_{wl}",
                            EncoderBlockRes1B(32, 32, (2, 2)))
        fused = 32 * len(self.win_lengths)
        self.encoder_block2 = EncoderBlockRes1B(fused, 64, (2, 2))
        for name, cin, cout, down in _TRUNK_ENC:
            self.add_module(name, EncoderBlockRes1B(cin, cout, down))
        for name, cin, cout, up in _TRUNK_DEC:
            self.add_module(name, DecoderBlockRes1B(cin, cout, up))
        self.decoder_block6 = DecoderBlockRes1B(64, 32, (2, 2),
                                                skip_channels=fused)
        self.after_conv = Conv2d(32, output_channels * K, (1, 1))

    def forward(self, input_dict: Dict[str, Any], target_length: int
                ) -> Dict[str, torch.Tensor]:
        mags = input_dict["stft_mixture_mag"]
        film = self.film(input_dict["condition"])
        target_bins = RECON_WIN // 2
        ref_mag = mags[RECON_WIN]  # (B, T, 257, C)
        origin_t = ref_mag.shape[1]
        pad_t = -origin_t % TIME_DOWNSAMPLE_RATIO

        pools, skips = [], []
        for wl in self.win_lengths:
            # (B, C, T, F_win) in NCHW strides: the permuted view of a
            # one-channel input also passes for channels_last, which the
            # convs would then keep, and the mask kernel needs unit-stride
            # logit rows
            x = mags[wl].float().permute(0, 3, 1, 2).clone(
                memory_format=torch.contiguous_format)
            x = getattr(self, f"bn0_{wl}")(x)
            x = adapt_freq(x[..., :x.shape[-1] - 1], target_bins)
            x = F.pad(x, (0, 0, 0, pad_t)).to(self.compute_dtype)
            x = getattr(self, f"pre_conv_{wl}")(x)
            pool, skip = getattr(self, f"encoder_block1_{wl}")(
                x, film["encoder_block1s"][str(wl)])
            pools.append(pool)
            skips.append(skip)
        x1p, x1 = torch.cat(pools, dim=1), torch.cat(skips, dim=1)

        x2p, x2 = self.encoder_block2(x1p, film["encoder_block2"])
        x3p, x3 = self.encoder_block3(x2p, film["encoder_block3"])
        x4p, x4 = self.encoder_block4(x3p, film["encoder_block4"])
        x5p, x5 = self.encoder_block5(x4p, film["encoder_block5"])
        x6p, x6 = self.encoder_block6(x5p, film["encoder_block6"])
        xc, _ = self.conv_block7a(x6p, film["conv_block7a"])
        h = self.decoder_block1(xc, x6, film["decoder_block1"])
        h = self.decoder_block2(h, x5, film["decoder_block2"])
        h = self.decoder_block3(h, x4, film["decoder_block3"])
        h = self.decoder_block4(h, x3, film["decoder_block4"])
        h = self.decoder_block5(h, x2, film["decoder_block5"])
        h = self.decoder_block6(h, x1, film["decoder_block6"])
        logits = self.after_conv(h)[:, :, :origin_t]  # (B, C_out*K, T, 256)

        # the 512 window's mixture spectrum, rebuilt in float32
        mag = ref_mag.float().permute(0, 3, 1, 2)
        real_in = mag * input_dict["stft_mixture_cos"][RECON_WIN].float(
        ).permute(0, 3, 1, 2)
        imag_in = mag * input_dict["stft_mixture_sin"][RECON_WIN].float(
        ).permute(0, 3, 1, 2)
        waveform = apply_mask_and_reconstruct(
            logits, real_in, imag_in, target_length, self.recon_cfg,
            self.output_channels, self.K)
        return {"waveform": waveform}


def build_multistft_model(cfg, win_lengths) -> MultiSTFTResUNet30:
    """MultiSTFTResUNet30 from a Config (``lass_torch.config``): its
    channels, condition size, hop and compute dtype."""
    if cfg.model.compute_dtype not in _DTYPES:
        raise ValueError(f"model.compute_dtype must be one of "
                         f"{sorted(_DTYPES)}, got {cfg.model.compute_dtype!r}")
    return MultiSTFTResUNet30(
        input_channels=cfg.model.input_channels,
        output_channels=cfg.model.output_channels,
        condition_size=cfg.model.condition_size,
        win_lengths=tuple(win_lengths), hop_size=cfg.data.stft_hop_length,
        compute_dtype=_DTYPES[cfg.model.compute_dtype])

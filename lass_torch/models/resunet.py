"""ResUNet30 separator in PyTorch (counterpart of lass_tpu/models/resunet.py).

Waveform in, waveform out, FiLM-conditioned on a 512-d caption embedding:
STFT (window 1024, hop 160, center reflect) -> magnitude -> ``bn0`` over
the 513 frequency bins -> time padded to a multiple of 32 and frequency
cropped to 512 bins -> UNet (6 encoder blocks, a bottleneck, 6 decoder
blocks, ``after_conv``) -> K=3 complex mask with phase rotation against the
mixture -> ISTFT with the Nyquist bin exactly zero.

Layout is NCHW, (B, C, T, F), inside the UNet. The JAX package's frequency
folding is a TPU layout whose output equals the plain layout exactly, so
it has no counterpart here. Mixed precision follows the JAX package:
activations in ``compute_dtype``, float32 parameters cast at use, float32
DSP and mask math.

The fused-conv eval configuration is the JAX package's opt-in one, with
its switches as constructor keywords (all off by default): ``sparse_conv``
(``fused_act_conv3x3`` for every 3x3 conv of the two widest levels),
``fused_conv_block`` (``fused_residual_conv_block`` for encoder_block1's
block), ``fused_convT`` (``fused_act_convT`` for decoder_block5/6's
up-sampling), ``fuse_head`` (``apply_head_mask``: after_conv and the mask
in one kernel, one input channel only). With any of them on, the UNet's
activations are ``torch.channels_last`` in memory (logical shapes and
state dicts unchanged), and so with ``quantize``.

``quantize=True`` gives every residual block the int8 eval path of
``lass_torch/ops/quant.py`` (the JAX package's ``quantize`` switch at
``freq_fold=1``, its CLI's path); it needs a calibration before an eval
forward (``SeparationInference.calibrate``). Blocks that a fused kernel
takes stay on it in bf16, as in the JAX package. The state dict is
unchanged.

``remat`` is the JAX package's training rematerialization of the residual
blocks (``ResUNet30.remat``, the environment's ``LASS_TPU_REMAT`` when
None; default 'none'): 'wide' recomputes the two widest levels' blocks
(encoder_block1/2, decoder_block5/6) during the backward pass instead of
keeping their activations, 'all' every encoder and decoder block and
conv_block7a. It trades a second forward of those blocks for the memory
of their activations; the step's result is the same (BatchNorm's running
statistics are updated once, ``lass_torch.nn.layers.recomputing``). It
acts only in a train-mode forward with grad enabled: an eval forward,
under ``no_grad`` or in inference mode runs as with 'none', and the state
dict is the same in every mode.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from lass_torch.dsp.stft import STFTConfig, istft, stft
from lass_torch.models.film import FusedFiLM, resunet30_film_spec
from lass_torch.nn.blocks import DecoderBlockRes1B, EncoderBlockRes1B
from lass_torch.nn.fused import FusedDecoderBlockRes1B, FusedEncoderBlockRes1B
from lass_torch.nn.layers import BatchNorm, Conv2d, recomputing
from lass_torch.ops.masking import apply_complex_mask_ri, apply_head_mask

TIME_DOWNSAMPLE_RATIO = 32  # 2 ** (number of time-downsampling encoder blocks)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the serving configurations: ResUNet30 keywords of each (the fused ones
# are the JAX package's opt-in fused-conv eval configuration)
CONFIGS = {
    "default": {},
    "A": dict(sparse_conv=True, fused_convT=True, fuse_head=True),
    "B": dict(fused_conv_block=True, fused_convT=True, fuse_head=True),
}


# the two widest levels, where the JAX package runs its fused-conv kernels
_WIDE = ("encoder_block1", "encoder_block2", "decoder_block5",
         "decoder_block6")
_BLOCKS = (*(f"encoder_block{i}" for i in range(1, 7)), "conv_block7a",
           *(f"decoder_block{i}" for i in range(1, 7)))
# the blocks each training-remat mode recomputes (lass_tpu's wide_r /
# all_r; 'all' implies 'wide')
REMAT_BLOCKS = {"none": (), "wide": _WIDE, "all": _BLOCKS}


def remat_mode(remat: Optional[str] = None) -> str:
    """``remat``, or the environment's ``LASS_TPU_REMAT`` when None
    (default 'none'); anything but none/wide/all raises."""
    mode = remat if remat is not None else os.environ.get(
        "LASS_TPU_REMAT", "none")
    if mode not in REMAT_BLOCKS:
        raise ValueError(f"remat must be none/wide/all, got {mode!r}")
    return mode


def _remat_contexts():
    """``checkpoint``'s context_fn: the first pass runs as usual, the
    recompute updates no BatchNorm statistics."""
    return contextlib.nullcontext(), recomputing()


def remat_call(block: nn.Module, *args):
    """``block(*args)`` with its activations recomputed in the backward
    pass instead of kept (a non-reentrant checkpoint; no block draws random
    numbers, so no RNG state is replayed)."""
    return checkpoint(block, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=_remat_contexts)


class ResUNet30Base(nn.Module):
    """(B, C_in, T, 512) -> (B, C_out * K, T, 512) mask logits, or with
    the fused head decoder_block6's output (B, 32, T, 512), which the head
    kernel takes with after_conv's parameters. Holds ``bn0`` too, where the
    reference keeps it (``base.bn0``). The fused switches (module
    docstring) route the wide levels through the fused blocks of
    ``nn/fused.py``; ``remat`` (module docstring) picks the blocks a
    training forward recomputes."""

    def __init__(self, input_channels: int = 1, output_channels: int = 1,
                 K: int = 3, freq_bins: int = 513, momentum: float = 0.01,
                 sparse_conv: bool = False, fused_conv_block: bool = False,
                 fused_convT: bool = False, fuse_head: bool = False,
                 quantize: bool = False, remat: Optional[str] = None):
        super().__init__()
        self.remat = remat_mode(remat)
        fused = sparse_conv or fused_conv_block or fused_convT
        # the fused head takes one input channel (lass_tpu's rule)
        self.fuse_head = fuse_head and input_channels == 1 and K == 3
        # the fused kernels take channels_last activations, and the int8
        # route reads and writes NHWC (lass_torch/ops/quant.py)
        self.channels_last = fused or self.fuse_head or quantize
        block_options = dict(sparse_conv=sparse_conv,
                             fused_conv_block=fused_conv_block,
                             quantize=quantize)
        self.bn0 = BatchNorm(freq_bins, momentum, dim=3)
        self.pre_conv = Conv2d(input_channels, 32, (1, 1))
        enc = [("encoder_block1", 32, 32, (2, 2)),
               ("encoder_block2", 32, 64, (2, 2)),
               ("encoder_block3", 64, 128, (2, 2)),
               ("encoder_block4", 128, 256, (2, 2)),
               ("encoder_block5", 256, 384, (2, 2)),
               ("encoder_block6", 384, 384, (1, 2)),
               ("conv_block7a", 384, 384, (1, 1))]
        for name, cin, cout, down in enc:
            if fused and name in _WIDE:
                block = FusedEncoderBlockRes1B(cin, cout, down,
                                               momentum=momentum,
                                               **block_options)
            else:
                block = EncoderBlockRes1B(cin, cout, down, momentum=momentum,
                                          quantize=quantize)
            self.add_module(name, block)
        dec = [("decoder_block1", 384, 384, (1, 2)),
               ("decoder_block2", 384, 384, (2, 2)),
               ("decoder_block3", 384, 256, (2, 2)),
               ("decoder_block4", 256, 128, (2, 2)),
               ("decoder_block5", 128, 64, (2, 2)),
               ("decoder_block6", 64, 32, (2, 2))]
        for name, cin, cout, up in dec:
            if fused and name in _WIDE:
                block = FusedDecoderBlockRes1B(cin, cout, up,
                                               momentum=momentum,
                                               fused_convT=fused_convT,
                                               **block_options)
            else:
                block = DecoderBlockRes1B(cin, cout, up, momentum=momentum,
                                          quantize=quantize)
            self.add_module(name, block)
        self.after_conv = Conv2d(32, output_channels * K, (1, 1))

    def _block(self, name: str, *args):
        """Block ``name`` on ``args`` and its FiLM betas; recomputed in the
        backward pass where the remat mode names it and the forward trains
        with grad enabled."""
        block = getattr(self, name)
        if name in REMAT_BLOCKS[self.remat] and self.training and \
                torch.is_grad_enabled():
            return remat_call(block, *args)
        return block(*args)

    def forward(self, x: torch.Tensor, film: Dict[str, Any]) -> torch.Tensor:
        x = self.pre_conv(x)
        if self.channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        x1p, x1 = self._block("encoder_block1", x, film["encoder_block1"])
        x2p, x2 = self._block("encoder_block2", x1p, film["encoder_block2"])
        x3p, x3 = self._block("encoder_block3", x2p, film["encoder_block3"])
        x4p, x4 = self._block("encoder_block4", x3p, film["encoder_block4"])
        x5p, x5 = self._block("encoder_block5", x4p, film["encoder_block5"])
        x6p, x6 = self._block("encoder_block6", x5p, film["encoder_block6"])
        xc, _ = self._block("conv_block7a", x6p, film["conv_block7a"])
        h = self._block("decoder_block1", xc, x6, film["decoder_block1"])
        h = self._block("decoder_block2", h, x5, film["decoder_block2"])
        h = self._block("decoder_block3", h, x4, film["decoder_block3"])
        h = self._block("decoder_block4", h, x3, film["decoder_block4"])
        h = self._block("decoder_block5", h, x2, film["decoder_block5"])
        h = self._block("decoder_block6", h, x1, film["decoder_block6"])
        return h if self.fuse_head else self.after_conv(h)


def mask_inputs(mask_logits: torch.Tensor, real_in: torch.Tensor,
                imag_in: torch.Tensor, output_channels: int, K: int = 3):
    """The five (B * C_out, T, F) float32 inputs of the mask kernel, as
    views where the dtype allows: the logit channel slices k = 0, 1, 2 of
    (B, C_out * K, T, F) (channel o * K + k) and the spectrum (B, C, T, F+1)
    cropped to F bins. Needs C == C_out."""
    b, _, t, f = mask_logits.shape
    if real_in.shape[1] != output_channels:
        raise ValueError("mask apply needs input_channels == output_channels")
    x = mask_logits.float().view(b, output_channels, K, t, f)

    def rows(a):  # (B, C_out, T, F) view -> (B * C_out, T, F) view
        return a.reshape(b * output_channels, t, f)

    return (rows(x[:, :, 0]), rows(x[:, :, 1]), rows(x[:, :, 2]),
            rows(real_in[..., :f]), rows(imag_in[..., :f]))


def apply_mask_and_reconstruct(mask_logits: torch.Tensor,
                               real_in: torch.Tensor, imag_in: torch.Tensor,
                               audio_length: int, stft_cfg: STFTConfig,
                               output_channels: int, K: int = 3
                               ) -> torch.Tensor:
    """K=3 complex mask + phase rotation + ISTFT.

    mask_logits: (B, C_out * K, T, 512) cropped to the spectrum's T;
    real_in/imag_in: the raw mixture spectrum (B, C, T, 513) float32. The
    mask kernel reads the logit channel slices and the 513 -> 512 crop as
    strided views (``mask_inputs``); the Nyquist bin's output is exactly
    zero (zero logits there give a zero rotation factor), so the ISTFT
    runs with the truncated basis. Returns (B, C_out, L).
    """
    b, _, _, f = mask_logits.shape
    out_real, out_imag = apply_complex_mask_ri(*mask_inputs(
        mask_logits, real_in, imag_in, output_channels, K))
    truncated = f == stft_cfg.freq_bins - 1
    wav = istft(out_real, out_imag, audio_length, stft_cfg,
                truncated_nyquist=truncated)
    return wav.reshape(b, output_channels, audio_length)


def apply_fused_head_and_reconstruct(h: torch.Tensor, w: torch.Tensor,
                                     bias: torch.Tensor,
                                     real_in: torch.Tensor,
                                     imag_in: torch.Tensor, audio_length: int,
                                     stft_cfg: STFTConfig,
                                     output_channels: int) -> torch.Tensor:
    """Fused after_conv + K=3 mask (one kernel) + ISTFT.

    h: decoder_block6's output (B, 32, T_pad, 512), read for its first T
    rows; w/bias: after_conv's parameters; real_in/imag_in: the raw mixture
    spectrum (B, 1, T, 513), read as its first 512 bins. Counterpart of
    lass_tpu/models/resunet.py apply_fused_head_and_reconstruct: the
    Nyquist bin's output is exactly zero there too. Returns (B, C_out, L).
    """
    b, _, _, f = h.shape
    out_real, out_imag = apply_head_mask(h, w, bias, real_in, imag_in,
                                         output_channels)
    wav = istft(out_real, out_imag, audio_length, stft_cfg,
                truncated_nyquist=f == stft_cfg.freq_bins - 1)
    return wav.reshape(b, output_channels, audio_length)


class ResUNet30(nn.Module):
    """Full separator: ``forward({'mixture': (B, C, L), 'condition':
    (B, 512)}) -> {'waveform': (B, C, L)}`` (the reference's API).

    State-dict keys are the reference torch names under ``base.``, except
    that FiLM is one fused Linear (``film.weight``, ``film.bias``). The
    fused switches and ``remat`` (module docstring) leave the state dict
    as it is."""

    def __init__(self, input_channels: int = 1, output_channels: int = 1,
                 condition_size: int = 512, K: int = 3,
                 window_size: int = 1024, hop_size: int = 160,
                 compute_dtype: torch.dtype = torch.float32,
                 sparse_conv: bool = False, fused_conv_block: bool = False,
                 fused_convT: bool = False, fuse_head: bool = False,
                 quantize: bool = False, remat: Optional[str] = None):
        super().__init__()
        self.output_channels = output_channels
        self.K = K
        self.compute_dtype = compute_dtype
        self.stft_cfg = STFTConfig(n_fft=window_size, hop_length=hop_size)
        self.film = FusedFiLM(resunet30_film_spec(), condition_size)
        self.base = ResUNet30Base(
            input_channels, output_channels, K, self.stft_cfg.freq_bins,
            sparse_conv=sparse_conv, fused_conv_block=fused_conv_block,
            fused_convT=fused_convT, fuse_head=fuse_head, quantize=quantize,
            remat=remat)

    @property
    def remat(self) -> str:
        """The training-remat mode this model was built with."""
        return self.base.remat

    def forward(self, input_dict: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        mixture = input_dict["mixture"]  # (B, C, L)
        film = self.film(input_dict["condition"])
        audio_length = mixture.shape[-1]

        real_in, imag_in = stft(mixture, self.stft_cfg)  # (B, C, T, 513)
        mag = torch.sqrt(torch.clamp(real_in ** 2 + imag_in ** 2,
                                     min=1e-10))
        origin_t = mag.shape[2]
        pad_t = -origin_t % TIME_DOWNSAMPLE_RATIO
        # cast before bn0 so the UNet-facing chain stays in compute_dtype
        x = self.base.bn0(mag.to(self.compute_dtype))
        x = F.pad(x, (0, 0, 0, pad_t))[..., :self.stft_cfg.freq_bins - 1]
        if self.base.fuse_head:
            h = self.base(x, film)
            after = self.base.after_conv
            return {"waveform": apply_fused_head_and_reconstruct(
                h, after.weight, after.bias, real_in, imag_in, audio_length,
                self.stft_cfg, self.output_channels)}
        out = self.base(x, film)[:, :, :origin_t]
        if self.base.channels_last:  # the mask kernel reads unit-stride rows
            out = out.contiguous()
        waveform = apply_mask_and_reconstruct(
            out, real_in, imag_in, audio_length, self.stft_cfg,
            self.output_channels, self.K)
        return {"waveform": waveform}


def build_model(cfg, **switches) -> ResUNet30:
    """ResUNet30 from a Config (``lass_torch.config``); ``switches`` are
    ResUNet30's keywords: the fused-conv ones (``CONFIGS``), ``quantize``
    and ``remat`` (by default the environment's ``LASS_TPU_REMAT``)."""
    if cfg.model.model_type != "ResUNet30":
        raise NotImplementedError(cfg.model.model_type)
    if cfg.model.compute_dtype not in _DTYPES:
        raise ValueError(f"model.compute_dtype must be one of "
                         f"{sorted(_DTYPES)}, got {cfg.model.compute_dtype!r}")
    if cfg.model.dsp_precision not in ("default", "high", "highest"):
        raise ValueError(
            f"model.dsp_precision must be one of default/high/highest, "
            f"got {cfg.model.dsp_precision!r}")
    return ResUNet30(
        input_channels=cfg.model.input_channels,
        output_channels=cfg.model.output_channels,
        condition_size=cfg.model.condition_size,
        compute_dtype=_DTYPES[cfg.model.compute_dtype], **switches)

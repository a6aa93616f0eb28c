"""Windowed-sinc polyphase resampling (torchaudio.functional.resample
semantics: hann-windowed sinc, lowpass_filter_width=6, rolloff=0.99),
counterpart of lass_tpu/audio/resample.py. Two paths share one filter
bank:

- ``resample_np``: numpy, on the host (the data pipeline);
- ``resample``: on tensors, one strided ``F.conv1d`` (cuDNN on the card,
  in IEEE float32 as the JAX package runs it at ``Precision.HIGHEST``);
  the audio query path resamples on the card with it.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lass_torch.utils.precision import ieee_float32


@functools.lru_cache(maxsize=None)
def resample_kernel(orig_freq: int, new_freq: int,
                    lowpass_filter_width: int = 6,
                    rolloff: float = 0.99) -> Tuple[np.ndarray, int, int]:
    """Returns (kernel (L, width*2 + M), L, M) where L/M is the reduced
    up/down ratio and row i is the filter producing output phase i."""
    gcd = math.gcd(orig_freq, new_freq)
    orig = orig_freq // gcd  # M (input step per L outputs)
    new = new_freq // gcd    # L
    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))

    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    tpi = t * np.pi
    kernel = np.where(tpi == 0, 1.0, np.sin(tpi) / np.where(tpi == 0, 1, tpi))
    kernel = kernel * window * (base_freq / orig)
    return kernel.astype(np.float32), new, orig


def _output_length(length: int, orig_freq: int, new_freq: int) -> int:
    gcd = math.gcd(orig_freq, new_freq)
    return int(math.ceil((new_freq // gcd) * length / (orig_freq // gcd)))


def resample_np(x: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Host path. x: (..., L) float32."""
    if orig_freq == new_freq:
        return x
    kernel, new, orig = resample_kernel(orig_freq, new_freq)
    width = (kernel.shape[1] - orig) // 2
    lead = x.shape[:-1]
    length = x.shape[-1]
    xf = x.reshape(-1, length).astype(np.float32)
    num_steps = int(np.ceil(length / orig))
    pad_right = width + num_steps * orig - length
    xp = np.pad(xf, [(0, 0), (width, pad_right)])
    # frames: (B, num_steps, taps)
    taps = kernel.shape[1]
    strided = np.lib.stride_tricks.sliding_window_view(
        xp, taps, axis=1)[:, ::orig][:, :num_steps]
    out = np.einsum("bst,pt->bsp", strided, kernel)  # (B, steps, phases)
    out = out.reshape(xf.shape[0], -1)[:, : _output_length(length, orig_freq,
                                                           new_freq)]
    return out.reshape(lead + (out.shape[-1],))


# made outside inference mode whatever the caller's mode (as the STFT
# window in dsp/stft.py)
@functools.lru_cache(maxsize=16)
def _kernel_on(orig_freq: int, new_freq: int, device: torch.device
               ) -> torch.Tensor:
    kernel, _, _ = resample_kernel(orig_freq, new_freq)
    with torch.inference_mode(False):
        return torch.from_numpy(kernel)[:, None, :].to(device)


def resample(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """Device path. x: (..., L) -> (..., ceil(L * new / orig)) float32, on
    x's device: the filter bank as an (L, 1, taps) conv weight at stride M
    gives the L output phases of each input step."""
    if orig_freq == new_freq:
        return x
    kernel, _, orig = resample_kernel(orig_freq, new_freq)
    width = (kernel.shape[1] - orig) // 2
    lead = x.shape[:-1]
    length = x.shape[-1]
    xf = x.reshape(-1, 1, length).float()
    num_steps = -(-length // orig)
    xp = F.pad(xf, (width, width + num_steps * orig - length))
    with ieee_float32():
        out = F.conv1d(xp, _kernel_on(orig_freq, new_freq, xf.device),
                       stride=orig)  # (N, phases, steps)
    out = out.transpose(1, 2).reshape(xf.shape[0], -1)
    out = out[:, :_output_length(length, orig_freq, new_freq)]
    return out.reshape(lead + (out.shape[-1],))

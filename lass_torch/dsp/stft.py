"""STFT / ISTFT / magphase in PyTorch.

Same semantics as ``lass_tpu/dsp/stft.py`` (librosa conventions: center
reflect padding, periodic hann window padded to n_fft, rfft sign
convention), computed with FFTs instead of DFT-basis matmuls:

- analysis is ``torch.stft``;
- synthesis is ``torch.fft.irfft`` of each frame times the window, an
  overlap-add with ``F.fold``, and a division by the window-sumsquare
  envelope clamped at 1e-11 — the JAX package's fused basis matmul
  computes the same sum (weight 2 on interior bins, the imaginary parts of
  the DC and Nyquist bins ignored).

Everything runs in float32 whatever the model's compute dtype.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lass_torch.dsp.window import get_window, pad_center


@dataclasses.dataclass(frozen=True)
class STFTConfig:
    """STFT configuration (defaults = the ResUNet30 front end)."""

    n_fft: int = 1024
    hop_length: int = 160
    win_length: Optional[int] = None
    window: str = "hann"
    center: bool = True
    pad_mode: str = "reflect"

    @property
    def freq_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def effective_win_length(self) -> int:
        return self.win_length if self.win_length is not None else self.n_fft

    def num_frames(self, length: int) -> int:
        pad = self.n_fft // 2 if self.center else 0
        return (length + 2 * pad - self.n_fft) // self.hop_length + 1


@functools.lru_cache(maxsize=None)
def _padded_window(cfg: STFTConfig) -> np.ndarray:
    win = get_window(cfg.window, cfg.effective_win_length)
    return pad_center(win, cfg.n_fft).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window_sumsquare(cfg: STFTConfig, num_frames: int) -> np.ndarray:
    """Overlap-added squared-window envelope over the padded output length."""
    n, hop = cfg.n_fft, cfg.hop_length
    w2 = _padded_window(cfg).astype(np.float64) ** 2
    env = np.zeros((num_frames - 1) * hop + n)
    for i in range(num_frames):
        env[i * hop:i * hop + n] += w2
    return np.maximum(env, 1e-11).astype(np.float32)


# The cached device constants are made outside inference mode whatever
# the caller's mode: a tensor made under torch.inference_mode() cannot be
# saved for backward, and the first caller may be a serving forward while
# a later one trains.


@functools.lru_cache(maxsize=16)
def _window_on(cfg: STFTConfig, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_padded_window(cfg)).to(device)


@functools.lru_cache(maxsize=64)
def _envelope_on(cfg: STFTConfig, num_frames: int, device: torch.device
                 ) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_window_sumsquare(cfg, num_frames)).to(
            device)


def stft(x: torch.Tensor, cfg: STFTConfig = STFTConfig()
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """STFT over the last axis. x: (..., L) -> (real, imag) each (..., T, F),
    float32 and contiguous."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1]).float()
    spec = torch.stft(
        flat, cfg.n_fft, cfg.hop_length, win_length=cfg.n_fft,
        window=_window_on(cfg, flat.device), center=cfg.center,
        pad_mode=cfg.pad_mode, normalized=False, onesided=True,
        return_complex=True)  # (N, F, T)
    spec = spec.transpose(1, 2)
    t, f = spec.shape[1:]
    real = spec.real.contiguous().reshape(lead + (t, f))
    imag = spec.imag.contiguous().reshape(lead + (t, f))
    return real, imag


def istft(real: torch.Tensor, imag: torch.Tensor, length: int,
          cfg: STFTConfig = STFTConfig(), *,
          truncated_nyquist: bool = False) -> torch.Tensor:
    """Inverse STFT. real/imag: (..., T, F) -> (..., length).

    truncated_nyquist=True takes (..., T, F-1) inputs and treats the
    Nyquist bin as exactly zero (valid for the mask head's output, whose
    padded bin has a zero phase-rotation factor).
    """
    n, hop = cfg.n_fft, cfg.hop_length
    lead = real.shape[:-2]
    t_frames = real.shape[-2]
    re = real.float().reshape((-1,) + real.shape[-2:])
    im = imag.float().reshape((-1,) + imag.shape[-2:])
    if truncated_nyquist:
        re = F.pad(re, (0, 1))
        im = F.pad(im, (0, 1))
    window = _window_on(cfg, re.device)
    frames = torch.fft.irfft(torch.complex(re, im), n=n, dim=-1) * window
    padded_len = (t_frames - 1) * hop + n
    y = F.fold(frames.transpose(1, 2), output_size=(1, padded_len),
               kernel_size=(1, n), stride=(1, hop))  # (N, 1, 1, padded_len)
    y = y.reshape(-1, padded_len) / _envelope_on(cfg, t_frames, re.device)
    start = n // 2 if cfg.center else 0
    return y[:, start:start + length].reshape(lead + (length,))


def magphase(real: torch.Tensor, imag: torch.Tensor, clamp: float = 1e-10
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mag, cos, sin) with torchlibrosa.stft.magphase clamping semantics."""
    mag = torch.sqrt(real ** 2 + imag ** 2)
    denom = torch.clamp(mag, min=clamp)
    return mag, real / denom, imag / denom


def wav_to_spectrogram_complex(x: torch.Tensor,
                               cfg: STFTConfig = STFTConfig()
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, L) -> (real, imag) each (B, T, F, C), the JAX package's
    layout."""
    real, imag = stft(x, cfg)  # (B, C, T, F)
    return real.permute(0, 2, 3, 1), imag.permute(0, 2, 3, 1)

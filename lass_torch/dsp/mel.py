"""Log-mel front end of the CLAP audio tower (counterpart of
lass_tpu/dsp/mel.py): the torchlibrosa Spectrogram (power 2) +
LogmelFilterBank (librosa slaney mel filters with slaney norm, ref 1.0,
amin 1e-10, top_db None) at 48 kHz / n_fft 1024 / hop 480 / 64 mels /
fmin 50 / fmax 14000.

On tensors: the port's ``dsp/stft.py::stft`` (``torch.stft``, cuFFT on
the card), the power, one (F, n_mels) matmul in IEEE float32 (the JAX
package runs it at ``Precision.HIGHEST``), then dB. The filter bank and
the host path ``log_mel_spectrogram_np`` are numpy copies of the JAX
package's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from lass_torch.dsp.stft import STFTConfig, stft
from lass_torch.utils.precision import ieee_float32


def hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney (htk=False) scale."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    mels)


def mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    freqs)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: Optional[float]) -> np.ndarray:
    """(n_fft//2 + 1, n_mels) slaney-normalized triangular filters —
    librosa.filters.mel(htk=False, norm='slaney').T."""
    fmax = fmax if fmax is not None else sr / 2
    fftfreqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(np.array(fmin))[()],
                                    hz_to_mel(np.array(fmax))[()],
                                    n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class LogMelConfig:
    sample_rate: int = 48000
    n_fft: int = 1024
    hop_length: int = 480
    n_mels: int = 64
    fmin: float = 50.0
    fmax: Optional[float] = 14000.0
    ref: float = 1.0
    amin: float = 1e-10
    top_db: Optional[float] = None

    @property
    def stft_cfg(self) -> STFTConfig:
        return STFTConfig(n_fft=self.n_fft, hop_length=self.hop_length)

    def filterbank(self) -> np.ndarray:
        return mel_filterbank(self.sample_rate, self.n_fft, self.n_mels,
                              self.fmin, self.fmax)


def log_mel_spectrogram_np(x: np.ndarray, cfg: LogMelConfig = LogMelConfig()
                           ) -> np.ndarray:
    """Host log-mel of one clip of any length (the fusion mel stack is
    built on the host): center reflect pad, periodic hann, rfft power,
    slaney filter bank, dB, in float64. (L,) -> (T, n_mels) float32."""
    x = np.asarray(x, np.float64)
    n, hop = cfg.n_fft, cfg.hop_length
    pad = n // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    frames = 1 + len(x) // hop
    k = np.arange(n)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))  # periodic hann
    idx = (np.arange(frames) * hop)[:, None] + k[None, :]
    spec = np.fft.rfft(xp[idx] * w, axis=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ cfg.filterbank().astype(np.float64)
    db = 10.0 * np.log10(np.maximum(mel, cfg.amin))
    db = db - 10.0 * np.log10(max(cfg.amin, cfg.ref))
    if cfg.top_db is not None:
        db = np.maximum(db, db.max() - cfg.top_db)
    return db.astype(np.float32)


# made outside inference mode whatever the caller's mode (as the STFT
# window in dsp/stft.py): a later caller may need it in an autograd graph
@functools.lru_cache(maxsize=16)
def _filterbank_on(cfg: LogMelConfig, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(cfg.filterbank()).to(device)


def log_mel_spectrogram(x: torch.Tensor, cfg: LogMelConfig = LogMelConfig()
                        ) -> torch.Tensor:
    """(..., L) -> (..., T, n_mels) log-mel in dB, float32."""
    real, imag = stft(x, cfg.stft_cfg)
    power = real * real + imag * imag
    with ieee_float32():
        mel = torch.matmul(power, _filterbank_on(cfg, power.device))
    db = 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin))
    db = db - 10.0 * math.log10(max(cfg.amin, cfg.ref))
    if cfg.top_db is not None:
        db = torch.maximum(db, db.max() - cfg.top_db)
    return db

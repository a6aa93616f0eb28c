"""SDR / SI-SDR metrics (counterpart of lass_tpu/evaluation/metrics.py).

The NumPy functions are the parity oracle of the DCASE harness and are
copied from the JAX package as they are (reference utils.py:148-290); they
run on the host. ``batch_sdr`` / ``batch_sisdr`` compute the same per-clip
metrics on (B, L) torch tensors on their device.
"""
from __future__ import annotations

import numpy as np
import torch


def calculate_sdr(ref: np.ndarray, est: np.ndarray, eps: float = 1e-10) -> float:
    noise = est - ref
    num = np.clip(np.mean(ref ** 2), eps, None)
    den = np.clip(np.mean(noise ** 2), eps, None)
    return float(10.0 * np.log10(num / den))


def calculate_sisdr(ref: np.ndarray, est: np.ndarray) -> float:
    eps = np.finfo(ref.dtype).eps
    reference = ref.reshape(-1, 1).astype(ref.dtype)
    estimate = est.reshape(-1, 1).astype(ref.dtype)
    rss = float(reference.T @ reference)
    a = (eps + float(reference.T @ estimate)) / (rss + eps)
    e_true = a * reference
    e_res = estimate - e_true
    sss = float((e_true ** 2).sum())
    snn = float((e_res ** 2).sum())
    return float(10 * np.log10((eps + sss) / (eps + snn)))


def get_mean_sdr_from_dict(sdris_dict) -> float:
    """reference utils.py:228-230."""
    return float(np.nanmean(list(sdris_dict.values())))


def calculate_segmentwise_sdr(ref: np.ndarray, est: np.ndarray,
                              hop_samples: int,
                              return_sdr_list: bool = False):
    """Median of per-segment SDRs (reference utils.py:273-290)."""
    min_len = min(ref.shape[-1], est.shape[-1])
    sdrs = []
    pointer = 0
    while pointer + hop_samples < min_len:
        sdrs.append(calculate_sdr(ref[..., pointer:pointer + hop_samples],
                                  est[..., pointer:pointer + hop_samples]))
        pointer += hop_samples
    sdr = float(np.nanmedian(sdrs))
    return (sdr, sdrs) if return_sdr_list else sdr


def remove_silence(audio: np.ndarray, sample_rate: int,
                   threshold: float = 0.02) -> np.ndarray:
    """Drop 100 ms frames whose peak is below threshold
    (reference utils.py:233-263)."""
    window = int(sample_rate * 0.1)
    n = (len(audio) // window) * window
    frames = audio[:n].reshape(-1, window)
    active = np.max(np.abs(frames), axis=-1) > threshold
    return frames[active].flatten()


def repeat_to_length(audio: np.ndarray, segment_samples: int) -> np.ndarray:
    """Tile audio up to a target length (reference utils.py:265-271)."""
    repeats = segment_samples // audio.shape[-1] + 1
    return np.tile(audio, repeats)[:segment_samples]


def batch_sdr(ref: torch.Tensor, est: torch.Tensor, eps: float = 1e-10
              ) -> torch.Tensor:
    """(B, L) -> (B,) SDR on the tensors' device."""
    noise = est - ref
    num = torch.clamp(torch.mean(ref ** 2, dim=-1), min=eps)
    den = torch.clamp(torch.mean(noise ** 2, dim=-1), min=eps)
    return 10.0 * torch.log10(num / den)


def batch_sisdr(ref: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """(B, L) -> (B,) scale-invariant SDR on the tensors' device."""
    eps = torch.finfo(ref.dtype).eps
    rss = torch.sum(ref * ref, dim=-1, keepdim=True)
    a = (eps + torch.sum(ref * est, dim=-1, keepdim=True)) / (rss + eps)
    e_true = a * ref
    e_res = est - e_true
    sss = torch.sum(e_true ** 2, dim=-1)
    snn = torch.sum(e_res ** 2, dim=-1)
    return 10.0 * torch.log10((eps + sss) / (eps + snn))

"""Audio features for CLAP audio queries (counterpart of
lass_tpu/models/clap/audio_features.py; host numpy code with explicit
``np.random.Generator``s).

The reference's get_audio_features (CLAP training/data.py:451-563): a clip
shorter than max_len is filled ('repeatpad': whole copies, then zeros;
'pad': zeros; 'repeat': copies cropped), a longer one is truncated
('rand_trunc': a random crop; 'fusion': three random mel chunks + the
resized global mel, for a fusion-enabled HTSAT, which LASS disables,
clap_encoder.py:22).

For LASS's audio queries the clip is 10 s at 48 kHz (resampled from the
data's rate), len == max_len, and this is the identity.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from lass_torch.dsp.mel import LogMelConfig, log_mel_spectrogram_np
from lass_torch.models.clap.fusion import build_mel_fusion


def prepare_audio(
    waveform: np.ndarray,
    max_len: int = 480000,
    data_filling: str = "repeatpad",
    data_truncating: str = "rand_trunc",
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """(L,) -> (max_len,) float32."""
    rng = rng or np.random.default_rng()
    n = len(waveform)
    if n > max_len:
        if data_truncating in ("rand_trunc", "fusion"):
            # a non-fusion encoder takes a random crop of a long clip (the
            # 'fusion' mel stack needs a fusion-enabled encoder)
            start = int(rng.integers(0, n - max_len + 1))
            return np.asarray(waveform[start:start + max_len],
                              dtype=np.float32)
        raise NotImplementedError(data_truncating)
    if n == max_len:
        return np.asarray(waveform, dtype=np.float32)
    out = np.zeros(max_len, np.float32)
    if data_filling == "repeatpad":
        reps = max_len // n
        out[:reps * n] = np.tile(waveform, reps)
    elif data_filling == "pad":
        out[:n] = waveform
    elif data_filling == "repeat":
        reps = -(-max_len // n)
        out[:] = np.tile(waveform, reps)[:max_len]
    else:
        raise NotImplementedError(data_filling)
    return out


def prepare_audio_fusion(
    waveform: np.ndarray,
    max_len: int = 480000,
    data_filling: str = "repeatpad",
    mel_cfg: Optional[LogMelConfig] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, bool, np.ndarray]:
    """(L,) -> (mel_fusion (4, chunk_frames, n_mels), longer, audio
    (max_len,)), the 'fusion' branch of get_audio_features: a long clip
    gives three random mel chunks + the resized global mel and a random
    audio crop; a short or exact one is filled and its whole mel stacked
    four times, with longer False."""
    mel_cfg = mel_cfg or LogMelConfig()
    rng = rng or np.random.default_rng()
    waveform = np.asarray(waveform, np.float32)
    n = len(waveform)
    chunk_frames = max_len // mel_cfg.hop_length + 1
    if n > max_len:
        mel = log_mel_spectrogram_np(waveform, mel_cfg)
        mel_fusion, longer = build_mel_fusion(mel, chunk_frames, rng)
        start = int(rng.integers(0, n - max_len + 1))
        audio = waveform[start:start + max_len]
    else:
        audio = prepare_audio(waveform, max_len, data_filling)
        mel = log_mel_spectrogram_np(audio, mel_cfg)
        mel_fusion = np.stack([mel, mel, mel, mel]).astype(np.float32)
        longer = False
    return mel_fusion, longer, audio


def prepare_audio_batch(waveforms: np.ndarray, max_len: int = 480000,
                        data_filling: str = "repeatpad") -> np.ndarray:
    """(B, L) of one length -> (B, max_len) float32."""
    b, n = waveforms.shape
    if n == max_len:
        return np.asarray(waveforms, np.float32)
    if n > max_len:
        return np.asarray(waveforms[:, :max_len], np.float32)
    return np.stack([
        prepare_audio(w, max_len, data_filling) for w in waveforms])

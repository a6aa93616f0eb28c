"""Audio-text dataset over JSON datafiles (counterpart of
lass_tpu/data/datafiles.py).

Schema ``{"data": [{"wav": path, "caption": str}, ...]}``. Clips shorter
than 0.5 s are dropped, stereo is averaged to mono, other rates are
resampled on the host, and each clip is randomly cropped or zero-padded
to ``max_clip_len`` seconds. A clip that fails to load gives None and is
counted; the loader (``datamodule.collate``'s caller) skips it.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from lass_torch.audio.io import read_audio
from lass_torch.audio.resample import resample_np


class AudioTextDataset:
    def __init__(self, datafiles: List[str], sampling_rate: int = 32000,
                 max_clip_len: float = 5, suppress_warnings: bool = False):
        items = []
        for datafile in datafiles:
            with open(datafile) as f:
                items.extend(json.load(f)["data"])
        self.items = items
        self.sampling_rate = sampling_rate
        self.max_length = int(max_clip_len * sampling_rate)
        self.suppress_warnings = suppress_warnings
        self.dropped_files_count = 0

    def __len__(self) -> int:
        return len(self.items)

    def _crop_or_pad(self, waveform: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
        n = waveform.shape[1]  # waveform: (1, samples)
        if n > self.max_length:
            start = int(rng.integers(0, n - self.max_length + 1))
            return waveform[:, start:start + self.max_length]
        out = np.zeros((1, self.max_length), np.float32)
        out[:, :n] = waveform
        return out

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None
                    ) -> Optional[Dict]:
        rng = rng or np.random.default_rng()
        entry = self.items[index]
        path = entry["wav"]
        try:
            audio, rate = read_audio(path)
            if audio.shape[1] < rate * 0.5:
                raise ValueError(f"{path} is shorter than 0.5 s")
        except Exception as exc:  # noqa: BLE001 — a bad clip is skipped
            self.dropped_files_count += 1
            if not self.suppress_warnings:
                print(f"Error: {exc} when loading {path} "
                      f"(item {index}); skipping.")
            return None
        mono = audio.mean(axis=0) if audio.shape[0] > 1 else audio[0]
        if rate != self.sampling_rate:
            mono = resample_np(mono, rate, self.sampling_rate)
        waveform = self._crop_or_pad(mono[None, :].astype(np.float32), rng)
        return {
            "text": entry["caption"],
            "waveform": waveform,
            "modality": "audio_text",
            "original_audiopath": path,
        }

    def get_dropped_count(self) -> int:
        return self.dropped_files_count

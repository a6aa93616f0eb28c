"""Precomputed multi-resolution STFT dataset (counterpart of
lass_tpu/data/precomputed.py).

Scans ``batch_*.npz`` files of ``lass_torch.data.precompute`` (or of the
JAX package's, the same schema), indexes items by a cumulative count with
a bisect lookup and caches one file. Item schema (reference
scripts/precompute_stfts.py:60-83):

    {'stfts': {'mixture'|'segment': {win: (mag, cos, sin)}},
     'text', 'mixture_component_texts', 'target_waveform',
     'stft_common_params', 'stft_win_lengths'}

Arrays are numpy, (B, T, F, C) as stored. ``batch_at`` loads every key of
a file; ``iterate_batches`` yields whole files as ready batches (the
training path: no per-item re-collation). ``win_lengths`` reads the first
file's array names only: lass_tpu's loads that file through the one-file
cache, so its ``batch_at`` of any other file loads two.
"""
from __future__ import annotations

import bisect
import glob
import os
import re
from typing import Dict, Iterator, List, Optional

import numpy as np

_FILE_RE = re.compile(r"batch_(\d+)\.npz$")


class PrecomputedSTFTDataset:
    def __init__(self, data_dir: str):
        paths = sorted(
            p for p in glob.glob(os.path.join(data_dir, "batch_*.npz"))
            if _FILE_RE.search(p))
        self.paths: List[str] = []
        self.counts: List[int] = []
        for p in paths:
            try:
                with np.load(p, allow_pickle=False) as z:
                    n = int(z["target_waveform"].shape[0])
            except Exception:
                continue  # skip empty/corrupt files (reference :160-161)
            if n > 0:
                self.paths.append(p)
                self.counts.append(n)
        self.cumulative = np.cumsum([0] + self.counts).tolist()
        self._cache_path: Optional[str] = None
        self._cache: Optional[Dict[str, np.ndarray]] = None

    def __len__(self) -> int:
        return self.cumulative[-1]

    def _load(self, path: str) -> Dict[str, np.ndarray]:
        if path != self._cache_path:
            with np.load(path, allow_pickle=False) as z:
                self._cache = {k: z[k] for k in z.files}
            self._cache_path = path
        return self._cache

    def win_lengths(self) -> List[int]:
        """The windows of the first file, from its array names (the zip
        directory: no array is read, and the cached file stays)."""
        with np.load(self.paths[0], allow_pickle=False) as z:
            names = z.files
        return sorted({int(m.group(1)) for k in names
                       for m in [re.match(r"stft_mixture_(\d+)_mag", k)]
                       if m})

    def batch_at(self, file_index: int) -> Dict:
        """Whole stored batch as the training-ready nested dict."""
        data = self._load(self.paths[file_index])
        wins = self.win_lengths()

        def role(name):
            return {w: (data[f"stft_{name}_{w}_mag"],
                        data[f"stft_{name}_{w}_cos"],
                        data[f"stft_{name}_{w}_sin"]) for w in wins}

        return {
            "stfts": {"mixture": role("mixture"), "segment": role("segment")},
            "text": [str(t) for t in data["text"]],
            "mixture_component_texts": [
                [str(x) for x in row if str(x)]
                for row in data["mixture_component_texts"]],
            "target_waveform": data["target_waveform"],
            "stft_common_params": {
                "hop_length": int(data["stft_hop_length"]),
                "window": "hann", "center": True, "pad_mode": "reflect"},
            "stft_win_lengths": wins,
        }

    def __getitem__(self, index: int) -> Dict:
        if index < 0 or index >= len(self):
            raise IndexError(index)
        file_idx = bisect.bisect_right(self.cumulative, index) - 1
        local = index - self.cumulative[file_idx]
        batch = self.batch_at(file_idx)

        def slice_role(role):
            return {w: tuple(a[local] for a in triple)
                    for w, triple in role.items()}

        return {
            "stfts": {"mixture": slice_role(batch["stfts"]["mixture"]),
                      "segment": slice_role(batch["stfts"]["segment"])},
            "text": batch["text"][local],
            "mixture_component_texts":
                batch["mixture_component_texts"][local],
            "target_waveform": batch["target_waveform"][local],
            "stft_common_params": batch["stft_common_params"],
            "stft_win_lengths": batch["stft_win_lengths"],
        }

    def iterate_batches(self, loop: bool = False) -> Iterator[Dict]:
        while True:
            for i in range(len(self.paths)):
                yield self.batch_at(i)
            if not loop:
                return

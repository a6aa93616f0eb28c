"""Deterministic synthetic audio-text corpus (counterpart of
lass_tpu/data/synth.py): PCM WAV clips of tones over filtered noise plus a
datafile in the dataset's schema, so the whole training pipeline can run
where no audio dataset is at hand. Same arguments, byte-identical corpus
(and the same bytes as the JAX package's writer)."""
from __future__ import annotations

import json
import os

import numpy as np

from lass_torch.audio.io import write_wav


def make_synth_corpus(
    out_dir: str,
    num_clips: int = 256,
    sample_rate: int = 16000,
    seconds_min: float = 6.0,
    seconds_max: float = 20.0,
    alt_rate_fraction: float = 0.05,
    alt_rate: int = 32000,
    seed: int = 0,
) -> str:
    """Write ``num_clips`` wavs + ``datafile.json`` under ``out_dir`` and
    return the datafile's path. A fraction ``alt_rate_fraction`` of the
    clips is written at ``alt_rate`` to exercise the resampler. An
    existing corpus with the same parameters is reused."""
    os.makedirs(out_dir, exist_ok=True)
    datafile = os.path.join(out_dir, "datafile.json")
    stamp = {
        "num_clips": num_clips, "sample_rate": sample_rate,
        "seconds_min": seconds_min, "seconds_max": seconds_max,
        "alt_rate_fraction": alt_rate_fraction, "alt_rate": alt_rate,
        "seed": seed,
    }
    if os.path.exists(datafile):
        try:
            with open(datafile) as f:
                existing = json.load(f)
            if existing.get("synth_params") == stamp and all(
                    os.path.exists(e["wav"]) for e in existing["data"]):
                return datafile
        except (json.JSONDecodeError, KeyError):
            pass

    wav_dir = os.path.join(out_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(num_clips):
        rate = alt_rate if rng.random() < alt_rate_fraction else sample_rate
        seconds = float(rng.uniform(seconds_min, seconds_max))
        n = int(seconds * rate)
        t = np.arange(n, dtype=np.float32) / rate
        freq = float(rng.uniform(80.0, 4000.0))
        tone = np.sin(2 * np.pi * freq * t, dtype=np.float32)
        noise = rng.standard_normal(n).astype(np.float32)
        k = int(rng.integers(1, 8))  # box-blur width that colours the noise
        if k > 1:
            c = np.cumsum(np.concatenate([[0.0], noise]))
            noise = ((c[k:] - c[:-k]) / k).astype(np.float32)
            noise = np.pad(noise, (0, n - noise.shape[0]))
        a = float(rng.uniform(0.2, 0.8))
        clip = (a * tone + (1 - a) * noise) * 0.25
        path = os.path.join(wav_dir, f"clip_{i:05d}.wav")
        write_wav(path, clip, rate)
        entries.append({
            "wav": os.path.abspath(path),
            "caption": f"a synthetic {freq:.0f} hertz tone over "
                       f"filtered noise, clip {i}",
        })
    with open(datafile, "w") as f:
        json.dump({"data": entries, "synth_params": stamp}, f)
    return datafile


def write_train_config(
    path: str,
    datafile: str,
    batch_size: int = 16,
    segment_seconds: float = 10.0,
    num_workers: int = 8,
    save_step_frequency: int = 20000,
    compute_dtype: str = "bfloat16",
    use_text_ratio: float = 1.0,
    wire_dtype: str = "float32",
) -> str:
    """Minimal train-config YAML (the surface of
    config/audiosep_base.yaml) pointed at a synthetic corpus."""
    with open(path, "w") as f:
        f.write(
            "task_name: AudioSep\n"
            "data:\n"
            f"    datafiles: ['{datafile}']\n"
            "    sampling_rate: 16000\n"
            f"    segment_seconds: {segment_seconds}\n"
            "model:\n"
            f"    compute_dtype: {compute_dtype}\n"
            f"    use_text_ratio: {use_text_ratio}\n"
            "train:\n"
            f"    num_workers: {num_workers}\n"
            f"    batch_size_per_device: {batch_size}\n"
            f"    save_step_frequency: {save_step_frequency}\n"
            f"    wire_dtype: {wire_dtype}\n"
        )
    return path

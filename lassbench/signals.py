"""Traffic signals, made from a seed: synthetic clips, SNR mixtures,
captions, a synthetic training corpus, and the WAV and host resampling
arithmetic the plain reference reads it with.

Frozen copies of the program's generators, so that a change to the
program cannot change the traffic:

- ``synth_clip`` and ``write_corpus``: ``lass_torch/data/synth.py``
  (``_synth_clip``, ``make_synth_corpus``: a tone over box-blurred noise,
  scaled by 0.25; clips of 6-20 s, a fraction at 32 kHz; PCM16 WAV files
  and a datafile in the dataset's schema);
- ``make_snr_mixture``: ``lass_torch/evaluation/dcase.py`` (the
  reference evaluator's SNR scaling and declip at 0.9);
- ``resample_kernel`` / ``resample_np``: ``lass_torch/audio/resample.py``
  (hann-windowed sinc, width 6, rolloff 0.99).
"""
from __future__ import annotations

import functools
import json
import math
import os
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

WORDS = (
    "dog bark barking cat meow bird chirp chirping car engine idling horn "
    "siren wind rain thunder water stream flowing door slam knock footsteps "
    "walking running child laughing woman speaking man talking crowd "
    "applause music piano guitar violin drum cymbal bell ringing clock "
    "ticking phone keyboard typing glass breaking metal clanking wood "
    "creaking train passing airplane overhead helicopter motorcycle truck "
    "brakes squealing frog croaking insects buzzing bee cow mooing sheep "
    "horse galloping rooster crowing owl hooting waves crashing fire "
    "crackling kettle whistling vacuum cleaner drill hammer saw chainsaw "
    "loud quiet distant nearby soft sharp low high slowly quickly outside "
    "indoors street kitchen forest beach city park room hall").split()


def synth_clip(rng: np.random.Generator, n: int, rate: int) -> np.ndarray:
    """A tone over box-blurred noise, scaled by 0.25, float32 (n,)."""
    t = np.arange(n, dtype=np.float32) / rate
    tone = np.sin(2 * np.pi * float(rng.uniform(80.0, 4000.0)) * t,
                  dtype=np.float32)
    noise = rng.standard_normal(n).astype(np.float32)
    k = int(rng.integers(1, 8))
    if k > 1:
        noise = np.convolve(noise, np.ones(k, np.float32) / k,
                            mode="same").astype(np.float32)
    a = float(rng.uniform(0.2, 0.8))
    return ((a * tone + (1 - a) * noise) * 0.25).astype(np.float32)


def make_snr_mixture(source: np.ndarray, noise: np.ndarray, snr_db: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """SNR-scaled mixture + declip: (possibly rescaled source, mixture)."""
    n = min(len(source), len(noise))
    source, noise = source[:n].copy(), noise[:n].copy()
    source_power = np.mean(source ** 2)
    noise_power = np.mean(noise ** 2)
    desired = source_power / (10 ** (snr_db / 10))
    noise = noise * np.sqrt(desired / max(noise_power, 1e-20))
    mixture = source + noise
    peak = np.max(np.abs(mixture))
    if peak > 1:
        source *= 0.9 / peak
        mixture *= 0.9 / peak
    return source, mixture


def mixtures(rng: np.random.Generator, clips: np.ndarray, count: int,
             snr_db: Sequence[float]) -> np.ndarray:
    """``count`` mixtures (count, L) of two different clips of the pool
    (P, L) at a uniform integer SNR in [snr_db[0], snr_db[1]]."""
    out = np.empty((count, clips.shape[1]), np.float32)
    for i in range(count):
        a, b = rng.choice(len(clips), 2, replace=False)
        snr = int(rng.integers(snr_db[0], snr_db[1] + 1))
        out[i] = make_snr_mixture(clips[a], clips[b], snr)[1]
    return out


def clip_pool(rng: np.random.Generator, count: int, seconds: float,
              rate: int) -> np.ndarray:
    n = int(round(seconds * rate))
    return np.stack([synth_clip(rng, n, rate) for _ in range(count)])


def captions(rng: np.random.Generator, count: int, words: Sequence[int],
             tag: str) -> List[str]:
    """``count`` captions of ``words[0]``-``words[1]`` words drawn from
    ``WORDS``, each ending in its own index, so that none repeats."""
    lengths = rng.integers(words[0], words[1] + 1, count)
    picks = rng.integers(0, len(WORDS), (count, words[1]))
    return [" ".join(WORDS[j] for j in row[:k]) + f" {tag}{i}"
            for i, (row, k) in enumerate(zip(picks, lengths))]


def write_wav_pcm16(path: str, data: np.ndarray, rate: int) -> None:
    payload = np.round(np.clip(data, -1.0, 1.0) * 32767.0).astype(
        "<i2").tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", 1, 1, rate, rate * 2, 2, 16))
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)


def read_wav_pcm16(path: str) -> Tuple[np.ndarray, int]:
    """A mono PCM16 WAV as ``write_wav_pcm16`` writes it -> (float32
    samples / 32768, rate)."""
    with open(path, "rb") as f:
        head = f.read(44)
        riff, _, wave = struct.unpack("<4sI4s", head[:12])
        fmt, channels, rate, _, _, bits = struct.unpack("<HHIIHH",
                                                        head[20:36])
        if (riff, wave, fmt, channels, bits) != (b"RIFF", b"WAVE", 1, 1, 16):
            raise ValueError(f"{path}: not a mono PCM16 WAV")
        data = np.frombuffer(f.read(), "<i2")
    return data.astype(np.float32) / 32768.0, rate


def write_corpus(out_dir: str, num_clips: int, sample_rate: int,
                 seconds_min: float, seconds_max: float,
                 alt_rate_fraction: float, alt_rate: int, seed: int) -> str:
    """``num_clips`` WAVs + ``datafile.json`` under ``out_dir``; returns
    the datafile. Reused when one with these parameters is there."""
    stamp = {"num_clips": num_clips, "sample_rate": sample_rate,
             "seconds_min": seconds_min, "seconds_max": seconds_max,
             "alt_rate_fraction": alt_rate_fraction, "alt_rate": alt_rate,
             "seed": seed}
    datafile = os.path.join(out_dir, "datafile.json")
    if os.path.exists(datafile):
        with open(datafile) as f:
            try:
                existing = json.load(f)
            except json.JSONDecodeError:
                existing = {}
        if existing.get("synth_params") == stamp and all(
                os.path.exists(e["wav"]) for e in existing["data"]):
            return datafile
    wav_dir = os.path.join(out_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(num_clips):
        rate = alt_rate if rng.random() < alt_rate_fraction else sample_rate
        n = int(float(rng.uniform(seconds_min, seconds_max)) * rate)
        clip = synth_clip(rng, n, rate)
        path = os.path.abspath(os.path.join(wav_dir, f"clip_{i:05d}.wav"))
        write_wav_pcm16(path, clip, rate)
        words = " ".join(WORDS[j] for j in rng.choice(len(WORDS), 6,
                                                        replace=False))
        entries.append({"wav": path, "caption": f"{words} clip {i}"})
    tmp = datafile + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"data": entries, "synth_params": stamp}, f)
    os.replace(tmp, datafile)
    return datafile


@functools.lru_cache(maxsize=None)
def resample_kernel(orig_freq: int, new_freq: int,
                    lowpass_filter_width: int = 6,
                    rolloff: float = 0.99) -> Tuple[np.ndarray, int, int]:
    """(kernel (L, taps) float32, L, M): row i is output phase i's filter,
    L/M the reduced up/down ratio."""
    gcd = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // gcd, new_freq // gcd
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


def resampled_length(length: int, orig_freq: int, new_freq: int) -> int:
    gcd = math.gcd(orig_freq, new_freq)
    return int(math.ceil((new_freq // gcd) * length / (orig_freq // gcd)))


def resample_np(x: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """(L,) float32 at orig_freq -> new_freq, on the host."""
    if orig_freq == new_freq:
        return x
    kernel, _, orig = resample_kernel(orig_freq, new_freq)
    width = (kernel.shape[1] - orig) // 2
    length = x.shape[-1]
    steps = -(-length // orig)
    xp = np.pad(x.astype(np.float32), (width, width + steps * orig - length))
    frames = np.lib.stride_tricks.sliding_window_view(
        xp, kernel.shape[1])[::orig][:steps]
    out = np.einsum("st,pt->sp", frames, kernel).reshape(-1)
    return out[:resampled_length(length, orig_freq, new_freq)]


def corpus_entries(datafile: str) -> List[Dict]:
    with open(datafile) as f:
        return json.load(f)["data"]

"""Deterministic synthetic audio-text corpus (counterpart of
lass_tpu/data/synth.py): PCM WAV clips of tones over filtered noise plus a
datafile in the dataset's schema, so the whole training pipeline can run
where no audio dataset is at hand. Same arguments, byte-identical corpus
(and the same bytes as the JAX package's writer). ``make_synth_shards``
(the port's own) writes such clips as tar shards, WAV or FLAC, for CLAP
pretraining and the linear probe."""
from __future__ import annotations

import io
import json
import os
import tarfile

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


def _synth_clip(rng: np.random.Generator, n: int, rate: int
                ) -> np.ndarray:
    """A tone over box-blurred noise, scaled by 0.25 (make_synth_corpus's
    recipe)."""
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


def make_synth_shards(out_dir: str, num_shards: int = 2,
                      per_shard: int = 4, seconds: float = 10.0,
                      sample_rate: int = 48000, audio_format: str = "wav",
                      num_classes: int = 0, tags_per_clip: int = 1,
                      distinct: int = 0, seed: int = 0) -> str:
    """``num_shards`` tar shards of ``per_shard`` samples each in the
    webdataset layout (``<key>.wav`` or ``<key>.flac`` + ``<key>.json``
    with a ``text`` list and, with ``num_classes``, a ``tag`` list of
    ``tags_per_clip`` distinct classes ``class_<k>``, each naming a column
    of ``out_dir/classes.json``), and ``sizes.json``; returns the shards'
    brace pattern. ``distinct`` > 0
    writes only that many different clips and cycles them (the FLAC
    encoder is slow); every sample keeps its own key and caption."""
    from lass_torch.audio.flac import encode_flac

    if audio_format not in ("wav", "flac"):
        raise ValueError(f"audio_format {audio_format!r}")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(seconds * sample_rate)
    total = num_shards * per_shard
    payloads = []
    for _ in range(distinct or total):
        clip = _synth_clip(rng, n, sample_rate)
        if audio_format == "flac":
            payloads.append(encode_flac(clip[None], sample_rate))
        else:
            buf = os.path.join(out_dir, "_clip.wav")
            write_wav(buf, clip, sample_rate)
            with open(buf, "rb") as f:
                payloads.append(f.read())
            os.remove(buf)
    if num_classes:
        with open(os.path.join(out_dir, "classes.json"), "w") as f:
            json.dump({f"class_{k}": k for k in range(num_classes)}, f)
    sizes = {}
    for s in range(num_shards):
        name = f"train-{s:06d}.tar"
        with tarfile.open(os.path.join(out_dir, name), "w") as tf:
            for j in range(per_shard):
                i = s * per_shard + j
                key = f"s{s:03d}k{j:04d}"
                meta = {"text": [f"synthetic sound number {i}",
                                 f"a tone over noise, clip {i}"]}
                if num_classes:
                    meta["tag"] = [f"class_{k}" for k in sorted(rng.choice(
                        num_classes, tags_per_clip, replace=False))]
                for ext, data in ((audio_format,
                                   payloads[i % len(payloads)]),
                                  ("json", json.dumps(meta).encode())):
                    info = tarfile.TarInfo(f"{key}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
        sizes[name] = per_shard
    with open(os.path.join(out_dir, "sizes.json"), "w") as f:
        json.dump(sizes, f)
    return os.path.join(out_dir, "train-{%06d..%06d}.tar"
                        % (0, num_shards - 1))


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
    evaluate_step_frequency: int = 10000,
    random_seed: int = 1234,
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
            f"    evaluate_step_frequency: {evaluate_step_frequency}\n"
            f"    random_seed: {random_seed}\n"
        )
    return path


def make_synth_eval_set(
    out_dir: str,
    num_rows: int = 48,
    seconds: float = 10.0,
    num_captions: int = 16,
    sample_rate: int = 16000,
    seed: int = 0,
) -> str:
    """A DCASE-style eval set where no validation data is at hand: one
    source wav (a tone with two harmonics) and one noise wav (coloured
    noise) per row, an SNR from -5 to 5 dB, and ``num_captions`` distinct
    captions; written under ``out_dir`` with its CSV (source, noise, snr,
    caption), whose path is returned. For ``DCASEEvaluator(eval_indexes=
    <csv>, audio_dir=out_dir)``."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(seconds * sample_rate)
    t = np.arange(n, dtype=np.float32) / sample_rate
    freqs = np.geomspace(120.0, 3000.0, num_captions)
    rows = []
    for i in range(num_rows):
        k = i % num_captions
        phase = float(rng.uniform(0, 2 * np.pi))
        tone = sum(np.sin(2 * np.pi * h * freqs[k] * t + phase,
                          dtype=np.float32) / h for h in (1, 2, 3))
        noise = rng.standard_normal(n).astype(np.float32)
        width = int(rng.integers(1, 8))  # box-blur width that colours it
        noise = np.convolve(noise, np.ones(width, np.float32) / width,
                            mode="same").astype(np.float32)
        write_wav(os.path.join(out_dir, f"source_{i:03d}.wav"),
                  (0.2 * tone).astype(np.float32), sample_rate)
        write_wav(os.path.join(out_dir, f"noise_{i:03d}.wav"),
                  0.2 * noise, sample_rate)
        rows.append((f"source_{i:03d}", f"noise_{i:03d}",
                     int(rng.integers(-5, 6)),
                     f"a {freqs[k]:.0f} hertz tone with its harmonics"))
    path = os.path.join(out_dir, "eval.csv")
    with open(path, "w") as f:
        f.write("source,noise,snr,caption\n")
        f.writelines(f"{s},{z},{snr},{c}\n" for s, z, snr, c in rows)
    return path

"""Resample a corpus to 16 kHz mono with a -3 dBFS peak (counterpart of
scripts/process_audio.py; the reference's scripts/process_audio.sh runs
``sox -r 16000 -c 1 gain -n -3`` in parallel jobs): every ``.wav`` under
the input directory, averaged to mono, resampled with the windowed-sinc
resampler (``lass_torch.audio.resample.resample_np``), its peak scaled to
``--gain_dbfs`` and written as 16-bit PCM at the same relative path under
the output directory, by a pool of processes. A file that fails is
skipped and reported at the end.

    python -m lass_torch.process_audio --input_dir IN --output_dir OUT \\
        [--rate 16000] [--gain_dbfs -3] [--jobs 8]
"""
import argparse
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context


def process_one(job):
    """(src, dst, rate, gain_dbfs) -> None, or the error as text."""
    src, dst, rate, gain_dbfs = job
    import numpy as np

    from lass_torch.audio.io import read_wav, write_wav
    from lass_torch.audio.resample import resample_np

    try:
        audio, sr = read_wav(src)
        mono = audio.mean(axis=0) if audio.shape[0] > 1 else audio[0]
        if sr != rate:
            mono = resample_np(mono, sr, rate)
        peak = np.abs(mono).max()
        if peak > 0:
            mono = mono * (10 ** (gain_dbfs / 20.0) / peak)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        write_wav(dst, mono[None, :], rate, bits=16)
        return None
    except Exception as exc:  # keep the sweep going; reported at the end
        return f"{src}: {exc}"


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m lass_torch.process_audio")
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--rate", type=int, default=16000)
    parser.add_argument("--gain_dbfs", type=float, default=-3.0)
    parser.add_argument("--jobs", type=int, default=os.cpu_count())
    args = parser.parse_args(argv)

    jobs = []
    for root, _dirs, files in os.walk(args.input_dir):
        for name in files:
            if not name.lower().endswith(".wav"):
                continue
            src = os.path.join(root, name)
            rel = os.path.relpath(src, args.input_dir)
            jobs.append((src, os.path.join(args.output_dir, rel),
                         args.rate, args.gain_dbfs))

    errors = []
    with ProcessPoolExecutor(max_workers=args.jobs,
                             mp_context=get_context("spawn")) as pool:
        for err in pool.map(process_one, jobs, chunksize=8):
            if err:
                errors.append(err)
    print(f"processed {len(jobs) - len(errors)}/{len(jobs)} files")
    for e in errors[:20]:
        print("  ERROR", e)


if __name__ == "__main__":
    main()

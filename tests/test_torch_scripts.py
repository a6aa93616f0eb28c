"""The port's script counterparts against the repository's scripts, on the
CPU:

- ``python -m lass_torch.process_audio`` writes the 16-bit wav bytes that
  scripts/process_audio.py's ``process_one`` writes for a short stereo
  44.1 kHz input (mono, 16 kHz, -3 dBFS peak), and reports a file it
  cannot read;
- ``python -m lass_torch.make_synth_dataset`` writes the datafile and the
  wav bytes of scripts/make_synth_dataset.py;
- ``python -m lass_torch.soak --tiny`` on the CPU trains a few steps,
  kills the run after its step-4 checkpoint, resumes it in a fresh
  process and reports the overlapping steps byte-exact.
"""
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest

from lass_torch import make_synth_dataset, process_audio, soak
from lass_torch.audio.io import read_wav, write_wav
from torch_threads import torch_threads_per_worker  # noqa: F401

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


def script(name):
    spec = importlib.util.spec_from_file_location(
        f"script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_process_audio_writes_the_scripts_bytes(tmp_path, capsys):
    rng = np.random.RandomState(0)
    t = np.arange(22050) / 44100.0
    stereo = np.stack([0.5 * np.sin(2 * np.pi * 440.0 * t),
                       0.2 * rng.randn(t.size)]).astype(np.float32)
    src = tmp_path / "in" / "sub" / "clip.wav"
    src.parent.mkdir(parents=True)
    write_wav(str(src), stereo, 44100)
    (tmp_path / "in" / "broken.wav").write_bytes(b"not a wav")
    ref = tmp_path / "ref.wav"
    assert script("process_audio").process_one(
        (str(src), str(ref), 16000, -3.0)) is None
    ours = tmp_path / "ours.wav"
    assert process_audio.process_one(
        (str(src), str(ours), 16000, -3.0)) is None
    assert ours.read_bytes() == ref.read_bytes()
    process_audio.main(["--input_dir", str(tmp_path / "in"),
                        "--output_dir", str(tmp_path / "out"),
                        "--jobs", "1"])
    assert (tmp_path / "out" / "sub" / "clip.wav").read_bytes() == \
        ref.read_bytes()
    printed = capsys.readouterr().out
    assert "processed 1/2 files" in printed and "broken.wav" in printed
    audio, sr = read_wav(str(ref))
    assert sr == 16000 and audio.shape == (1, 8000)
    assert np.abs(audio).max() == pytest.approx(10 ** (-3 / 20), abs=1e-4)


def test_make_synth_dataset_writes_the_scripts_corpus(tmp_path, capsys,
                                                      monkeypatch):
    args = ["--num", "3", "--seconds_min", "0.2", "--seconds_max", "0.4",
            "--seed", "9", "--sample_rate", "8000"]
    make_synth_dataset.main(["--out", str(tmp_path / "ours")] + args)
    monkeypatch.setattr(sys, "argv", ["make_synth_dataset.py", "--out",
                                      str(tmp_path / "ref")] + args)
    script("make_synth_dataset").main()
    ours_path, ref_path = capsys.readouterr().out.split()
    ours, ref = json.load(open(ours_path)), json.load(open(ref_path))
    assert ours["synth_params"] == ref["synth_params"]
    assert [e["caption"] for e in ours["data"]] == [
        e["caption"] for e in ref["data"]]
    for a, b in zip(ours["data"], ref["data"]):
        assert os.path.basename(a["wav"]) == os.path.basename(b["wav"])
        assert open(a["wav"], "rb").read() == open(b["wav"], "rb").read()


def test_tiny_soak_resumes_byte_exact_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the two child processes
    report = tmp_path / "soak.json"
    # the kill comes at step 5, after the step-4 checkpoint; steps 6 and 7
    # and the eval leave the killer seconds to spare, and no later
    # checkpoint can overtake the step-4 one
    soak.main(["--steps", "7", "--kill_after", "4", "--save_every", "4",
               "--eval_every", "7", "--log_every", "1", "--batch", "1",
               "--tiny", "--device", "cpu", "--workspace",
               str(tmp_path / "ws"), "--report", str(report)])
    out = json.loads(report.read_text())
    assert out["resume_byte_exact"] and out["resumed_from_step"] == 4
    assert out["overlap_steps_compared"]
    assert [s for s, _ in out["loss_curve"]] == list(range(1, 8))
    assert np.isfinite([v for _, v in out["loss_curve"]]).all()
    assert [r["step"] for r in out["eval_records"]] == [7]
    assert np.isfinite(out["eval_records"][0]["eval_SDR"])
    shutil.rmtree(tmp_path / "ws")  # its full-width checkpoints

"""The port's offline STFT precompute, precomputed dataset and variant CLIs
against lass_tpu's, on the CPU.

A corpus of 8 synthetic clips of 1.05-1.3 s at 16 kHz (longer than the
2048 window's 1024-sample reflect padding), cut to 1 s:

- the STFT bank (256, 512, 2048) against lass_tpu's: magnitudes within
  1e-5 of the largest (FFT against a HIGHEST-precision DFT matmul,
  float32), cos and sin within 1e-3 where the magnitude is above 1e-3 of
  the largest (cos = re / mag amplifies the transforms' float32 difference
  where mag is small), and on a silent stretch both packages' power clamp:
  mag = sqrt(1e-10), cos = sin = 0 exactly;
- ``generate_recipes``: the same dict as lass_tpu's;
- ``compute_stfts``: the same files as lass_tpu's (texts, hop, windows
  identical; the target waveform within 1e-6 abs; the STFTs as above),
  and a file of either package loads in the other's dataset;
- the recipe mix against lass_tpu's ``_mix_from_recipe`` (1e-6 abs);
- the CLIs (``precompute_stfts``, ``inspect_batch``, ``train_multistft``
  for 1 step of each variant) in subprocesses with ``--device cpu``.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.data.datafiles import AudioTextDataset as JaxDataset
from lass_tpu.data.precompute import _mix_from_recipe as jax_mix
from lass_tpu.data.precompute import compute_stfts as jax_compute_stfts
from lass_tpu.data.precompute import generate_recipes as jax_recipes
from lass_tpu.data.precomputed import PrecomputedSTFTDataset as JaxStore
from lass_tpu.dsp.stft import multi_resolution_spectrogram_phase as jax_bank
from lass_torch.data.datafiles import AudioTextDataset
from lass_torch.data.precompute import (
    compute_stfts, generate_recipes, load_recipes, mix_from_recipe,
    save_recipes)
from lass_torch.data.precomputed import PrecomputedSTFTDataset
from lass_torch.data.synth import make_synth_corpus, write_train_config
from lass_torch.dsp.stft import (
    STFTConfig, multi_resolution_spectrogram_phase, wav_to_spectrogram_phase)
from torch_threads import torch_threads_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINS = (256, 512, 2048)
BATCH = 4
MAG_TOL, PHASE_TOL, PHASE_FLOOR = 1e-5, 1e-3, 1e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    datafile = make_synth_corpus(str(root / "clips"), num_clips=8,
                                 seconds_min=1.05, seconds_max=1.3,
                                 alt_rate_fraction=0.0, seed=3)
    config = write_train_config(str(root / "config.yaml"), datafile,
                                batch_size=BATCH, segment_seconds=1,
                                num_workers=1, save_step_frequency=100000,
                                compute_dtype="float32")
    return root, datafile, config


def _datasets(datafile):
    kwargs = dict(sampling_rate=16000, max_clip_len=1)
    return JaxDataset([datafile], **kwargs), AudioTextDataset([datafile],
                                                              **kwargs)


@pytest.mark.parametrize("max_mix_num", [2, 3])
def test_recipes_match_jax(corpus, max_mix_num):
    jds, ds = _datasets(corpus[1])
    args = (BATCH, max_mix_num, -10, 10, 7)
    got = generate_recipes(ds, *args)
    assert got == jax_recipes(jds, *args)
    assert len(got["recipes"]) == 8
    assert {len(r["partners"]) for r in got["recipes"].values()} <= set(
        range(1, max_mix_num))


@pytest.fixture(scope="module")
def both_stores(corpus):
    """compute_stfts of each package from the same recipes (max_mix_num 3,
    so that some items carry one partner and some two)."""
    root, datafile, _ = corpus
    jds, ds = _datasets(datafile)
    recipes = generate_recipes(ds, BATCH, 3, -10, 10, 7)
    path = str(root / "recipes.json")
    save_recipes(recipes, path)
    out = {"jax": str(root / "stfts_jax"), "torch": str(root / "stfts_torch")}
    assert jax_compute_stfts(jds, load_recipes(path), out["jax"],
                             win_lengths=WINS, batch_size=BATCH) == 2
    assert compute_stfts(ds, load_recipes(path), out["torch"],
                         win_lengths=WINS, batch_size=BATCH,
                         device="cpu") == 2
    return out, path


def _check_stft(mag, cos, sin, ref_mag, ref_cos, ref_sin, what):
    scale = float(np.abs(ref_mag).max())
    assert np.abs(mag - ref_mag).max() <= MAG_TOL * scale, what
    loud = ref_mag > PHASE_FLOOR * scale
    for got, ref in ((cos, ref_cos), (sin, ref_sin)):
        assert np.abs(got - ref)[loud].max() <= PHASE_TOL, what


@pytest.mark.parametrize("win", WINS)
def test_stft_bank_matches_jax(win):
    rng = np.random.RandomState(win)
    wave = (0.1 * rng.randn(2, 1, 16000)).astype(np.float32)
    got = multi_resolution_spectrogram_phase(torch.from_numpy(wave), (win,))
    ref = jax_bank(jnp.asarray(wave), (win,))
    assert got[win][0].shape == (2, 101, win // 2 + 1, 1)
    _check_stft(*(a.numpy() for a in got[win]),
                *(np.asarray(a) for a in ref[win]), win)


def test_stft_bank_clamps_the_power_on_silence():
    """On frames that see only zeros, both packages give mag = sqrt(eps)
    and cos = sin = 0 (the power clamp; torchlibrosa's magphase would give
    mag 0)."""
    wave = (0.1 * np.random.RandomState(0).randn(1, 1, 16000)).astype(
        np.float32)
    wave[..., 4000:12000] = 0.0
    got = multi_resolution_spectrogram_phase(torch.from_numpy(wave), WINS)
    ref = jax_bank(jnp.asarray(wave), WINS)
    for win in WINS:
        # frames whose window lies inside the silence
        frames = [t for t in range(101)
                  if 4000 <= t * 160 - win // 2 and t * 160 + win // 2 <= 12000]
        assert frames, win
        for bank in (tuple(a.numpy() for a in got[win]),
                     tuple(np.asarray(a) for a in ref[win])):
            mag, cos, sin = (a[0, frames] for a in bank)
            np.testing.assert_array_equal(mag, np.float32(np.sqrt(1e-10)))
            assert not cos.any() and not sin.any()


def test_recipe_mix_matches_jax():
    rng = np.random.RandomState(1)
    seg = (0.2 * rng.randn(5, 700)).astype(np.float32)
    seg[2] *= 20  # a loud clip: the declip branch
    seg[4] = 0.0  # a silent one: the energy floor
    partners = (0.3 * rng.randn(5, 2, 700)).astype(np.float32)
    gains = rng.randint(-10, 11, size=(5, 2)).astype(np.float32)
    noise_gain = rng.randint(-10, 11, size=5).astype(np.float32)
    mask = np.array([[1, 1], [1, 0], [1, 1], [1, 0], [1, 1]], np.float32)
    got = mix_from_recipe(*map(torch.from_numpy, (seg, partners, gains,
                                                  noise_gain, mask)))
    ref = jax_mix(*map(jnp.asarray, (seg, partners, gains, noise_gain,
                                     mask)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def _files(out_dir):
    return sorted(f for f in os.listdir(out_dir) if f.endswith(".npz"))


def test_stored_texts_match_jax(both_stores):
    out, _ = both_stores
    assert _files(out["jax"]) == _files(out["torch"]) == [
        "batch_000000.npz", "batch_000001.npz"]
    for name in _files(out["jax"]):
        with np.load(os.path.join(out["jax"], name)) as ref, np.load(
                os.path.join(out["torch"], name)) as got:
            assert sorted(got.files) == sorted(ref.files)
            for key in ("text", "mixture_component_texts",
                        "stft_hop_length", "stft_win_lengths"):
                np.testing.assert_array_equal(got[key], ref[key])
                assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_allclose(got["target_waveform"],
                                       ref["target_waveform"], atol=1e-6)


@pytest.mark.parametrize("win", WINS)
def test_stored_stfts_match_jax(both_stores, win):
    out, _ = both_stores
    for name in _files(out["jax"]):
        with np.load(os.path.join(out["jax"], name)) as ref, np.load(
                os.path.join(out["torch"], name)) as got:
            for role in ("mixture", "segment"):
                keys = [f"stft_{role}_{win}_{p}" for p in ("mag", "cos",
                                                           "sin")]
                assert got[keys[0]].shape == (BATCH, 101, win // 2 + 1, 1)
                assert all(got[k].dtype == np.float32 for k in keys)
                _check_stft(*(got[k] for k in keys), *(ref[k] for k in keys),
                            (name, role, win))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("reader", [JaxStore, PrecomputedSTFTDataset],
                         ids=["jax_reader", "torch_reader"])
def test_files_load_in_either_dataset(both_stores, writer, reader):
    store = reader(both_stores[0][writer])
    assert len(store) == 8
    assert store.win_lengths() == list(WINS)
    item = store[5]
    assert item["text"] == store.batch_at(1)["text"][1]
    mag, cos, sin = item["stfts"]["mixture"][512]
    assert mag.shape == cos.shape == sin.shape == (101, 257, 1)
    assert item["target_waveform"].shape == (1, 16000)
    assert item["stft_common_params"]["hop_length"] == 160
    assert 1 <= len(item["mixture_component_texts"]) <= 3
    with pytest.raises(IndexError):
        store[len(store)]
    batches = list(store.iterate_batches())
    assert len(batches) == 2 and batches[1]["text"] == store.batch_at(1)[
        "text"]


def test_stored_segment_matches_a_fresh_stft(both_stores):
    """The stored segment STFT is the STFT of the stored target (as
    tests/test_precompute.py holds lass_tpu's)."""
    batch = PrecomputedSTFTDataset(both_stores[0]["torch"]).batch_at(0)
    target = torch.from_numpy(batch["target_waveform"])
    for win in WINS:
        fresh = wav_to_spectrogram_phase(target, STFTConfig(n_fft=win))
        for got, stored in zip(fresh, batch["stfts"]["segment"][win]):
            np.testing.assert_array_equal(got.numpy(), stored)


# the CLIs' work here is small: two threads each keep them from
# oversubscribing the cores that the other test workers share
CLI_ENV = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}


def _run(*args, timeout=600):
    env = CLI_ENV
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_precompute_cli_writes_the_same_files(corpus, both_stores,
                                              tmp_path):
    _, _, config = corpus
    recipes = str(tmp_path / "recipes.json")
    out = _run("lass_torch.precompute_stfts", "--mode", "generate_recipes",
               "--config_yaml", config, "--output_file", recipes,
               "--batch_size", str(BATCH), "--seed", "7")
    assert "wrote 8 recipes" in out
    # the config's max_mix_num is 2; the store's recipes are of 3
    out = _run("lass_torch.precompute_stfts", "--mode", "compute_stfts",
               "--config_yaml", config, "--recipes", both_stores[1],
               "--output_dir", str(tmp_path / "stfts"), "--batch_size",
               str(BATCH), "--max_batches", "1", "--device", "cpu")
    assert "wrote 1 batch files" in out
    with np.load(tmp_path / "stfts" / "batch_000000.npz") as got, np.load(
            os.path.join(both_stores[0]["torch"], "batch_000000.npz")) as ref:
        assert sorted(got.files) == sorted(ref.files)
        for key in ref.files:
            np.testing.assert_array_equal(got[key], ref[key])
    listing = _run("lass_torch.inspect_batch",
                   str(tmp_path / "stfts" / "batch_000000.npz"), "--item",
                   "1")
    assert "4 items, 23 arrays" in listing
    assert "stft_mixture_2048_mag" in listing and "(4, 101, 1025, 1)" in \
        listing


def test_train_cli_runs_both_variants(corpus, tmp_path):
    """One step of each variant through ``python -m
    lass_torch.train_multistft --device cpu``, both processes at once, on
    a file of 2 clips of 0.5 s: finite loss in metrics.jsonl, the step-1
    checkpoint with the fusion's weight for negquery, kernel counts 0 (the
    CPU runs the plain versions)."""
    _, datafile, _ = corpus
    config = write_train_config(str(tmp_path / "config.yaml"), datafile,
                                batch_size=2, segment_seconds=0.5,
                                num_workers=1, save_step_frequency=100000,
                                compute_dtype="float32")
    dataset = AudioTextDataset([datafile], sampling_rate=16000,
                               max_clip_len=0.5)
    store = str(tmp_path / "stfts")
    assert compute_stfts(dataset, generate_recipes(dataset, 2, 2, -10, 10),
                         store, batch_size=2, max_batches=1,
                         device="cpu") == 1
    env = CLI_ENV
    procs = {}
    for variant in ("multistft", "negquery"):
        ws = tmp_path / variant
        procs[variant] = (ws, subprocess.Popen(
            [sys.executable, "-m", "lass_torch.train_multistft",
             "--workspace", str(ws), "--config_yaml", config,
             "--precomputed_dir", store, "--variant", variant,
             "--max_steps", "1", "--device", "cpu",
             "--launch_counts", str(ws / "counts.json")],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    sub = os.path.join("train_multistft", "config,devices=1")
    for variant, (ws, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        assert "finished at step 1" in stdout
        with open(ws / "tf_logs" / sub / "metrics.jsonl") as f:
            (record,) = map(json.loads, f)
        assert record["step"] == 1 and np.isfinite(record["train_loss"])
        assert record["load_s"] >= 0 and record["steps_per_sec"] > 0
        blob = torch.load(ws / "checkpoints" / sub / "1.ckpt",
                          weights_only=True)
        keys = blob["state_dict"]
        assert ("neg_query_fusion.fusion.weight" in keys) == (
            variant == "negquery")
        bn0 = {k for k in keys if k.startswith("ss_model.bn0_")}
        wins = (512,) if variant == "negquery" else WINS
        assert bn0 == {f"ss_model.bn0_{w}.{p}" for w in wins for p in (
            "weight", "bias", "running_mean", "running_var",
            "num_batches_tracked")}
        with open(ws / "counts.json") as f:
            assert not any(json.load(f).values())
